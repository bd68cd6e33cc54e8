"""The models' sharding call sites, multi-rank training and the sharded
dry run (``repro_torch.launch.dryrun``) beside the JAX package.

* **Sharded equals unsharded.**  Four gloo ranks in four processes that
  meet through a ``FileStore`` under the test's temporary directory (never
  a port) hold a (2, 2) ``("data", "model")`` mesh.  Each reduced config
  of the six families, on float32 weights converted from the JAX package,
  is placed on it as ``DTensor``s by the rules ``baseline`` and ``wg``
  (training's layouts), ``serve_baseline`` (the KV cache split along its
  length over the model axis), ``sp`` (the residual stream split along
  the sequence) and ``moe_ep`` (the tensor axis on the data ranks, which
  the batch takes too): its prefill logits, and those of one
  decode step after it, must be within 1e-5 relative L2 of the JAX
  package's unsharded ones (2e-4 for ssm, hybrid and moe, the families'
  own gates).
* **Training.**  ``launch.train`` on that mesh, with and without
  ``--weight-gather``, gives the one-rank run's losses within 1e-5 over
  two steps.
* **The dry run.**  ``run_cell`` on a fake (2, 2) mesh, every family
  times train/prefill/decode at the reduced size: ``ok``, collectives
  recorded, and ``argument_bytes`` equal to rank 0's shard bytes summed by
  hand from the shapes and placements.  One llama layer's weight gathers
  under the baseline and ``wg`` rules, and its gradient reduce-scatters
  under ``wg``, against a hand count; each family's train step's
  collective bytes against the JAX package's dry run of the same cell
  on four host devices.
* No test leaves a process group running.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.registry import get_family as jget_family  # noqa: E402
from repro_torch.configs import Shape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import make_cell  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = {"llama3.2-3b": 1e-5, "mamba2-2.7b": 2e-4, "phi3.5-moe-42b-a6.6b": 2e-4,
         "zamba2-2.7b": 2e-4, "whisper-base": 1e-5, "internvl2-76b": 1e-5}
RULES = ("baseline", "wg", "serve_baseline", "sp", "moe_ep", "dp", "serve_wg",
         "serve_repl")
B, S, EXTRA = 4, 16, 4          # batch, prompt, cache room past the prompt
STEPS = 2
COMPRESS = ["--accum-steps", "2", "--compress-grads"]
# one layer per stack (two for the hybrid: a Mamba layer and its group's
# shared attention block) keeps the runs and traces short
LAYERS = {"zamba2-2.7b": dict(n_layers=2, attn_every=2),
          "whisper-base": dict(n_layers=1, enc_layers=1)}


def _layers(arch):
    return LAYERS.get(arch, dict(n_layers=1))

WORKER = r"""
import json, shutil, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import get_family
from repro_torch.parallel.sharding import (RULE_VARIANTS, mesh_sharding, place,
                                           place_module, place_tree,
                                           tree_shardings, use_mesh)

cpu = torch.device("cpu")
spec = json.loads(sys.argv[6])
mesh = make_host_mesh(("data", "model"), device_type="cpu", shape=(2, 2))
res = {}
for arch in spec["archs"]:
    ref = np.load(f"{data}/{arch}.npz")
    tree = {}
    for key in ref.files:
        if key.startswith("p/"):
            node = tree
            *path, leaf = key[2:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = ref[key]
    cfg = get_config(arch, reduced=True).replace(**spec["layers"][arch])
    fam = get_family(cfg)
    for rv in spec["rules"]:
        r = RULE_VARIANTS[rv]
        model = convert.params_from_reference(cfg, tree, cpu)
        place_module(model, tree_shardings(mesh, fam.param_specs(cfg), r), mesh)
        batch = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files
                 if k.startswith("b/")}
        batch = {k: place(v.long() if k == "tokens" else v, mesh,
                          mesh_sharding(mesh, ("batch",) + (None,) * (v.dim() - 1), r))
                 for k, v in batch.items()}
        cache = fam.init_cache(cfg, spec["b"], int(ref["max_len"]),
                               dtype=torch.float32, device=cpu)
        cache = place_tree(cache, tree_shardings(mesh, fam.cache_specs(cfg), r), mesh)
        nxt = place(torch.from_numpy(ref["next"]).long(), mesh,
                    mesh_sharding(mesh, ("batch", None), r))
        with use_mesh(mesh, r), torch.no_grad():
            logits, cache = fam.prefill(model, cfg, batch, cache)
            dlogits, _ = fam.decode_step(model, cfg, nxt, cache)
        res[f"{arch}:{rv}"] = [logits.full_tensor().numpy().tolist(),
                               dlogits.full_tensor().numpy().tolist()]
def argv(steps):
    return ["--arch", "llama3.2-3b", "--reduced", "--steps", str(steps),
            "--global-batch", str(spec["b"]), "--seq-len", str(spec["s"]),
            "--device", "cpu", "--mesh", "2x2", "--log-every", "1"]
for wg in (False, True):
    res[f"train:{wg}"] = launch.main(argv(spec["steps"])
                                     + (["--weight-gather"] if wg else []))
res["train:compress"] = launch.main(argv(spec["steps"]) + spec["compress"])
ckpt = ["--ckpt-dir", spec["ckpt"], "--ckpt-every", str(spec["steps"])]
res["ckpt:first"] = launch.main(argv(spec["steps"]) + ckpt)
dist.barrier()   # rank 0's checkpoint is on disk before any rank resumes
if rank == 0:    # kept for one rank to resume from
    shutil.copytree(spec["ckpt"], spec["ckpt"] + "_one")
dist.barrier()
res["ckpt:resumed"] = launch.main(argv(spec["steps"] + 1) + ckpt)
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
"""


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(arch, rng):
    """The weights (the JAX package's draw) and inputs of ``arch``'s
    reduced config in float32, flattened for ``np.savez``."""
    jcfg = jget_config(arch, reduced=True).replace(dtype="float32", **_layers(arch))
    jfam = jget_family(jcfg)
    params = jax.tree.map(np.asarray, jfam.init(jax.random.PRNGKey(7), jcfg))
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if jcfg.family == "vlm":
        batch["vision_embeds"] = (rng.normal(size=(B, jcfg.vision_tokens,
                                                   jcfg.d_model)) * 0.02).astype(np.float32)
    if jcfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(B, jcfg.source_len, jcfg.d_model))
                           * 0.02).astype(np.float32)
    nxt = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    max_len = S + EXTRA + (jcfg.vision_tokens if jcfg.family == "vlm" else 0)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = v
    walk(params, "")
    return {**flat, **{f"b/{k}": v for k, v in batch.items()},
            "next": nxt, "max_len": np.asarray(max_len)}


def _reference(arch, arrays):
    """The JAX package's unsharded prefill logits and those of one decode
    step after it, on ``_inputs``' arrays."""
    jcfg = jget_config(arch, reduced=True).replace(dtype="float32", **_layers(arch))
    jfam = jget_family(jcfg)
    params = {}
    for key, a in arrays.items():
        if key.startswith("p/"):
            node = params
            *path, leaf = key[2:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(a)
    jb = {k[2:]: jnp.asarray(v) for k, v in arrays.items() if k.startswith("b/")}
    cache = jfam.init_cache(jcfg, B, int(arrays["max_len"]), dtype=jnp.float32)
    logits, cache = jfam.prefill(params, jcfg, jb, cache)
    dlogits, _ = jfam.decode_step(params, jcfg, jnp.asarray(arrays["next"]), cache)
    return np.asarray(logits), np.asarray(dlogits)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One run of ``WORKER`` on four gloo ranks: each family's sharded
    logits under each rule table and the 4-rank training losses, beside
    the JAX package's logits and the one-rank launcher's losses."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        arrays[arch] = _inputs(arch, rng)
        np.savez(tmp / f"{arch}.npz", **arrays[arch])
    spec = {"archs": list(ARCHS), "rules": list(RULES), "b": B, "s": S,
            "steps": STEPS, "layers": {a: _layers(a) for a in ARCHS},
            "compress": COMPRESS, "ckpt": str(tmp / "ckpt4")}
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(tmp / "store"), str(tmp),
         str(tmp / "out.json"), json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:   # the JAX package's logits while the ranks run
        want = {arch: _reference(arch, a) for arch, a in arrays.items()}
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    got = json.loads((tmp / "out.json").read_text())

    import torch.distributed as dist
    from repro_torch.launch import train as launch

    def argv(steps):
        return ["--arch", "llama3.2-3b", "--reduced", "--steps", str(steps),
                "--global-batch", str(B), "--seq-len", str(S), "--device",
                "cpu", "--log-every", "1"]

    one = {}
    try:
        for wg in (False, True):
            one[wg] = launch.main(argv(STEPS) + (["--weight-gather"] if wg else []))
        one["compress"] = launch.main(argv(STEPS) + COMPRESS)
        one["ckpt:first"] = launch.main(argv(STEPS) + [
            "--ckpt-dir", str(tmp / "ckpt1"), "--ckpt-every", str(STEPS)])
        # one rank resumes from the four ranks' checkpoint of step 2
        one["ckpt:resumed"] = launch.main(argv(STEPS + 1) + [
            "--ckpt-dir", str(tmp / "ckpt4_one"), "--ckpt-every", str(STEPS)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return got, want, one, tmp


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_prefill_and_decode_match_the_unsharded_jax(four_ranks, arch, rules):
    got, want, _, _ = four_ranks
    logits, dlogits = got[f"{arch}:{rules}"]
    jl, jd = want[arch]
    assert np.shape(logits) == jl.shape and np.shape(dlogits) == jd.shape
    assert _rel(logits, jl) <= ARCHS[arch], (arch, rules, _rel(logits, jl))
    assert _rel(dlogits, jd) <= ARCHS[arch], (arch, rules, _rel(dlogits, jd))


@pytest.mark.parametrize("wg", [False, True], ids=["baseline", "wg"])
def test_four_rank_training_matches_one_rank(four_ranks, wg):
    got, _, one, _ = four_ranks
    losses = got[f"train:{wg}"]
    assert len(losses) == STEPS == len(one[wg])
    for a, b in zip(losses, one[wg]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses, one[wg])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_four_rank_compressed_training_matches_one_rank(four_ranks):
    """``--accum-steps 2 --compress-grads`` on the (2, 2) mesh: the
    one-rank run's losses, bit for bit."""
    got, _, one, _ = four_ranks
    assert len(got["train:compress"]) == STEPS
    assert got["train:compress"] == one["compress"]


def _leaves(directory, step):
    """{path: float64 array} of the checkpoint of ``step`` under
    ``directory``."""
    from repro_torch.train.checkpoint import _ckpt_name, load_pytree_flat

    flat = load_pytree_flat(os.path.join(str(directory), _ckpt_name(step)))
    return {k: (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64)) for k, v in flat.items()}


def _assert_leaves_close(a, b, rtol=1e-5):
    """Each leaf of ``a`` within ``rtol`` of ``b``'s in relative L2 norm,
    and equal where ``b``'s is zero: an absolute bound would pass any AdamW
    moment that sits below it."""
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        err, norm = np.linalg.norm(a[k] - b[k]), np.linalg.norm(b[k])
        assert err <= rtol * norm, (k, err, norm)


def test_four_rank_checkpoint_saves_and_resumes(four_ranks):
    """A checkpoint saved on the (2, 2) mesh after two steps holds the
    one-rank run's state (each leaf within 1e-5 of its norm); resuming it
    for a third step gives the same loss on the four ranks and on one, and
    the same state; the JAX package's ``restore_latest`` reads the four
    ranks' last checkpoint, leaf for leaf the values the port saved."""
    from repro import train as jtrain

    got, _, one, tmp = four_ranks
    assert got["ckpt:first"] == one["ckpt:first"] == got["train:False"]
    _assert_leaves_close(_leaves(tmp / "ckpt4", STEPS), _leaves(tmp / "ckpt1", STEPS))
    assert len(got["ckpt:resumed"]) == len(one["ckpt:resumed"]) == 1
    assert got["ckpt:resumed"] == one["ckpt:resumed"]
    _assert_leaves_close(_leaves(tmp / "ckpt4", STEPS + 1),
                         _leaves(tmp / "ckpt4_one", STEPS + 1))
    jcfg = jget_config("llama3.2-3b", reduced=True)
    like = jax.tree.map(np.asarray, jtrain.init_state(
        jax.random.PRNGKey(0), jcfg, jtrain.AdamWConfig()))
    jstep, jstate = jtrain.restore_latest(str(tmp / "ckpt4"), like)
    assert jstep == STEPS + 1        # the resumed four-rank run's last save
    assert jax.tree.structure(jstate) == jax.tree.structure(like)
    saved = _leaves(tmp / "ckpt4", STEPS + 1)
    jleaves = jax.tree.leaves(jstate)
    assert len(jleaves) == len(saved)
    for jleaf, (k, v) in zip(jleaves, saved.items()):
        assert np.array_equal(np.asarray(jleaf, np.float64), v), k


# --------------------------------------------------------------- dry run
def _hand_bytes(cell) -> int:
    """Rank 0's bytes of the cell's arguments from their shapes and
    placements: a dimension split n ways holds ceil(size / n) on rank 0."""
    def local(shape, plc, mesh_sizes):
        shape = list(shape)
        for i, p in enumerate(plc):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // mesh_sizes[i])
        return int(np.prod(shape))

    sizes = (2, 2)
    total = 0

    def walk(a, plc):
        nonlocal total
        if isinstance(a, torch.nn.Module):
            for n, p in a.named_parameters():
                total += local(p.shape, plc[n], sizes) * p.element_size()
        elif isinstance(a, torch.Tensor):
            total += local(a.shape, plc, sizes) * a.element_size()
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], plc[k])
        elif hasattr(a, "_fields"):
            if hasattr(a, "opt") and hasattr(a, "rng"):      # TrainState
                walk(a.params, plc.params)
                walk(a.opt.m, plc.opt.m)
                walk(a.opt.v, plc.opt.v)
                total += a.opt.step.element_size()
    for a, plc in zip(cell.args, cell.placements):
        walk(a, plc)
    return total


def _local_shape(shape, plc, sizes=(2, 2)):
    shape = list(shape)
    for i, p in enumerate(plc):
        if p.is_shard():
            shape[p.dim] = -(-shape[p.dim] // sizes[i])
    return tuple(shape)


def _dense_layer_trace(kind, rules):
    """One reduced llama layer's ``kind`` cell traced on a fake (2, 2)
    mesh under ``rules``: the recorded collectives and, for every weight
    split over the data ranks (its ``fsdp`` axis), its local shape."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_family
    from repro_torch.parallel.sharding import RULE_VARIANTS

    cfg = get_config("llama3.2-3b", reduced=True).replace(n_layers=1)
    specs = get_family(cfg).param_specs(cfg)
    with dryrun.virtual_ranks(4):
        mesh = make_host_mesh(("data", "model"), device_type="cpu", shape=(2, 2))
        cell = make_cell(cfg, Shape(f"reduced_{kind}", 8, B, kind), mesh,
                         rules=RULE_VARIANTS[rules], accum_steps=1)
        tr = dryrun.trace_cell(cell, mesh, torch.device("cpu"))
    model, plc = ((cell.args[0].params, cell.placements[0].params)
                  if kind == "train" else (cell.args[0], cell.placements[0]))
    fsdp = {n: _local_shape(p.shape, plc[n]) for n, p in model.named_parameters()
            if "fsdp" in specs[n]}
    return tr["collective_calls"], fsdp


def _gathered(local):
    """The result of gathering a local shard over the two data ranks: the
    functional all-gather stacks the pieces along the first dimension,
    whichever dimension is split."""
    return (2 * local[0],) + tuple(local[1:])


@pytest.mark.parametrize("rules", ["baseline", "wg"])
def test_one_dense_layer_gathers_the_weights_its_rules_say(rules):
    """A hand count of one llama layer's weight gathers in prefill, on a
    fake (2, 2) mesh.  Nine weights are split over the data ranks: the
    embedding table, the unembedding, wq, wk, wv, wo and the three FFN
    matrices.  Under ``wg`` every one of them is gathered once, at its
    ``weight`` access point.  Under the baseline no access point gathers:
    DTensor gathers a weight only inside an op that needs it whole along
    its fsdp dimension, which the matmuls contracting over it (wq, wk, wv,
    gate, up, the unembedding) and the embedding lookup do, and wo and
    down (split over the data ranks along their output dimension) do not.
    The weight gathers are the all-gathers over two ranks whose result is
    a gathered local shard; no activation all-gather of this cell has
    such a shape."""
    calls, fsdp = _dense_layer_trace("prefill", rules)
    assert set(fsdp) == {"embed.tok", "embed.out", "layers.0.attn.wq",
                         "layers.0.attn.wk", "layers.0.attn.wv",
                         "layers.0.attn.wo", "layers.0.ffn.gate",
                         "layers.0.ffn.up", "layers.0.ffn.down"}
    shapes = {_gathered(s) for s in fsdp.values()}
    got = sorted(shape for kind, _, n, shape in calls
                 if kind == "all-gather" and n == 2 and shape in shapes)
    gathered = set(fsdp) - ({"layers.0.attn.wo", "layers.0.ffn.down"}
                            if rules == "baseline" else set())
    assert got == sorted(_gathered(fsdp[n]) for n in gathered)
    assert sum(4 * math.prod(s) for s in got) == \
        sum(2 * 4 * math.prod(fsdp[n]) for n in gathered)


def test_one_dense_layer_reduce_scatters_each_weight_gradient_under_wg():
    """The same layer's train step under ``wg``: each weight's gathered
    gradient comes back split over the data ranks, a reduce-scatter whose
    result is the weight's local shard, at least once per weight."""
    calls, fsdp = _dense_layer_trace("train", "wg")
    got = [shape for kind, _, n, shape in calls
           if kind == "reduce-scatter" and n == 2]
    for name, local in fsdp.items():
        assert local in got, (name, local, got)
        got.remove(local)


REF_DRYRUN = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import Shape, get_config
from repro.launch import hlo
from repro.launch.specs import make_cell
from repro.parallel.sharding import RULE_VARIANTS

spec = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for arch in spec["archs"]:
    cfg = get_config(arch, reduced=True).replace(**spec["layers"][arch])
    for rv in spec["rules"]:
        cell = make_cell(cfg, Shape("reduced_train", 8, spec["b"], "train"), mesh,
                         rules=RULE_VARIANTS[rv], accum_steps=1)
        hlo_text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           donate_argnums=cell.donate_argnums
                           ).lower(*cell.args).compile().as_text()
        out[f"{arch}:{rv}"] = hlo.collective_bytes(hlo_text).bytes_by_kind
print(json.dumps(out))
"""
REF_RATIO = 2.5


@pytest.fixture(scope="module")
def reference_dry_run():
    """The JAX package's collective bytes by kind for each family's
    reduced train cell on a (2, 2) mesh of four host devices, compiled
    and read from its partitioned HLO, in a subprocess of its own (the
    device count is fixed when JAX starts)."""
    spec = {"archs": list(ARCHS), "rules": ["baseline", "wg"], "b": B,
            "layers": {a: _layers(a) for a in ARCHS}}
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REF_DRYRUN, json.dumps(spec)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rules", ["baseline", "wg"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_dry_run_collective_bytes_against_the_reference(reference_dry_run,
                                                        arch, rules):
    """Each family's train step on a (2, 2) mesh moves, in all, the
    reference's collective bytes within a factor of ``REF_RATIO`` either
    way.  The kinds differ and are not compared one by one: XLA's CPU
    partitioner reduces gradients with all-reduces where DTensor
    reduce-scatters them into the parameters' shards, and adds
    collective-permutes and all-to-alls of its own; DTensor picks each
    op's strategy by its own cost model, and gathers more activations
    (PERF.md, phase 15, holds the ratios)."""
    from repro_torch.parallel.sharding import RULE_VARIANTS

    cfg = get_config(arch, reduced=True).replace(**_layers(arch))
    shape = Shape("reduced_train", 8, B, "train")
    res = dryrun.run_cell(arch, shape.name, "pod", rules=RULE_VARIANTS[rules],
                          accum_steps=1, device="cpu", cfg=cfg, shape=shape,
                          mesh_shape=(2, 2))
    got = sum(res["collectives"]["bytes_by_kind"].values())
    want = sum(reference_dry_run[f"{arch}:{rules}"].values())
    assert want / REF_RATIO <= got <= want * REF_RATIO, (arch, rules, got, want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_dry_run_on_a_fake_2x2_mesh(arch, kind):
    import torch.distributed as dist
    cfg = get_config(arch, reduced=True).replace(**_layers(arch))
    shape = Shape(f"reduced_{kind}", 8, B, kind)
    res = dryrun.run_cell(arch, shape.name, "pod", device="cpu", cfg=cfg,
                          shape=shape, mesh_shape=(2, 2))
    assert not dist.is_initialized()
    assert res["ok"] and res["n_devices"] == 4 and res["t_compile_s"] is None
    assert sum(res["collectives"]["count_by_kind"].values()) > 0
    assert all(b > 0 for b in res["collectives"]["bytes_by_kind"].values())
    mem = res["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    # the hand sum, on a (2, 2) mesh of its own
    with dryrun.virtual_ranks(4):
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(("data", "model"), device_type="cpu", shape=(2, 2))
        cell = make_cell(cfg, shape, mesh)
        want = _hand_bytes(cell)
    assert mem["argument_bytes"] == want
    assert set(res["roofline"]) >= {"flops", "hbm_bytes", "coll_bytes",
                                    "model_flops", "t_compute", "t_memory",
                                    "t_collective", "bottleneck"}
    assert res["roofline"]["coll_bytes"] == sum(
        res["collectives"]["bytes_by_kind"].values())
    coll = res["collectives"]
    assert sum(coll["weight_gathers"].values()) <= coll["count_by_kind"].get(
        "all-gather", 0)
    assert coll["weight_gather_bytes"] <= coll["bytes_by_kind"].get("all-gather", 0)


def test_dryrun_cli_raises_without_cuda_and_writes_a_cpu_result(tmp_path):
    """``--device cuda`` (the default) raises without a card; the CPU
    run's file carries the reference's keys."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k"])
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--device", "cpu", "--results-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "whisper-base__decode_32k__pod.json").read_text())
    assert set(res) >= {"arch", "shape", "mesh", "tag", "n_devices", "ok",
                        "t_lower_s", "t_compile_s", "memory", "collectives",
                        "roofline", "raw_cost_analysis"}
    assert res["n_devices"] == 256 and res["ok"]
    assert set(res["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
