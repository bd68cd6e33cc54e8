"""The port's explicit expert-parallel MoE schedule
(``repro_torch.models.moe_a2a``) and the launcher's mesh path beside the
JAX package's: the twin of ``tests/test_moe_a2a.py``.

* no mesh: ``moe_dispatch="a2a"`` falls back to the sorted/dense dispatch;
* eight ranks: the schedule on a (2, 4) ``("data", "model")`` gloo mesh,
  and on a (2, 2, 2) ``("pod", "data", "model")`` one whose batch axes
  are two mesh axes, in eight processes that meet through a ``FileStore``
  under the test's temporary directory (never a port).  Each rank runs
  its batch shard; its output is held to its shard of the JAX package's
  ``moe_dense`` on the same numpy weights at 2e-4, and the gradients of
  the ranks' ``sum(y**2)``, summed over the ranks, to JAX's at 5e-4 /
  5e-3.  With ``n_model > 1`` a gradient counted once per model rank
  would show;
* ``launch.train``: three reduced llama steps through the host mesh and
  ``shard_batch`` give the JAX package's ``launch.train`` losses, both
  resuming from one checkpoint of the JAX package's initial state.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
_CFG = dict(name="t", family="moe", n_layers=2, d_model=32, vocab=64,
            n_heads=2, n_kv_heads=2, d_ff=64, n_experts=8, top_k=2,
            moe_d_ff=64, dtype="float32", capacity_factor=8.0)


def _weights(jcfg):
    return {k: np.asarray(v) for k, v in
            JL.moe_init(jax.random.PRNGKey(0), jcfg).items()}


def _port_moe(cfg, w):
    p = L.MoE(cfg, CPU)
    with torch.no_grad():
        for k, v in w.items():
            getattr(p, k).copy_(torch.from_numpy(v))
    return p


def test_a2a_unavailable_without_mesh_falls_back():
    from repro_torch.models import moe_a2a
    jcfg = JModelConfig(**_CFG, moe_dispatch="a2a")
    cfg = ModelConfig(**_CFG, moe_dispatch="a2a")
    w = _weights(jcfg)
    x = (np.random.default_rng(0).normal(size=(2, 16, 32)) * 0.1).astype(np.float32)
    moe_a2a.reset_call_count()
    out, aux = L.moe(_port_moe(cfg, w), cfg, torch.from_numpy(x))
    assert moe_a2a.call_count() == 0 and not moe_a2a.a2a_available(cfg)
    want, aux_w = JL.moe_dense({k: jnp.asarray(v) for k, v in w.items()}, jcfg,
                               jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=2e-4)


RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import layers as L, moe_a2a
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel.sharding import RULE_VARIANTS, use_mesh

    rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    ref = np.load(data)
    cfg = ModelConfig(**json.loads(str(ref["cfg"])))
    p = L.MoE(cfg, torch.device("cpu"))
    with torch.no_grad():
        for k in ("router", "gate", "up", "down"):
            getattr(p, k).copy_(torch.from_numpy(ref[k]))
    x = torch.from_numpy(ref["x"])
    errs = {}
    for shape, axes in (((2, 4), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        coord = mesh.get_coordinate()
        shard = coord[0] if len(shape) == 2 else coord[0] * 2 + coord[1]
        n_shards = 2 if len(shape) == 2 else 4
        b = x.shape[0] // n_shards
        xl = x[shard * b:(shard + 1) * b]
        moe_a2a.reset_call_count()
        with use_mesh(mesh, RULE_VARIANTS["moe_a2a"]):
            y, aux = L.moe(p, cfg, xl)
        assert moe_a2a.call_count() == 1
        np.testing.assert_allclose(y.detach().numpy(),
                                   ref["y"][shard * b:(shard + 1) * b],
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(float(aux), float(ref[f"aux_{n_shards}"]),
                                   rtol=2e-4)
        names = ("router", "gate", "up", "down")
        grads = torch.autograd.grad(torch.sum(y ** 2),
                                    [getattr(p, k) for k in names])
        for k, g in zip(names, grads):
            g = g.clone()
            dist.all_reduce(g)
            np.testing.assert_allclose(g.numpy(), ref["g_" + k], atol=5e-4,
                                       rtol=5e-3, err_msg=f"{axes} {k}")
            errs[f"{'x'.join(map(str, shape))}:{k}"] = float(
                np.abs(g.numpy() - ref["g_" + k]).max())
        errs[f"{'x'.join(map(str, shape))}:y"] = float(
            np.abs(y.detach().numpy() - ref["y"][shard * b:(shard + 1) * b]).max())
    with open(out, "w") as f:
        json.dump(errs, f)
    dist.destroy_process_group()
""")


def test_a2a_matches_oracle_on_8_ranks(tmp_path):
    jcfg = JModelConfig(**_CFG, moe_dispatch="a2a")
    w = _weights(jcfg)
    x = (np.random.default_rng(1).normal(size=(4, 16, 32)) * 0.1).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    want, _ = JL.moe_dense(jw, jcfg, jnp.asarray(x))
    g = jax.grad(lambda p: jnp.sum(JL.moe_dense(p, jcfg, jnp.asarray(x))[0] ** 2))(jw)
    # the aux loss a rank reports: the mean over the batch shards of each
    # shard's own load-balance loss (2 shards on the first mesh, 4 on the
    # second)
    aux = {n: np.mean([float(JL.moe_dense(jw, jcfg, jnp.asarray(xs))[1])
                       for xs in np.split(x, n)]) for n in (2, 4)}
    data = tmp_path / "ref.npz"
    np.savez(data, cfg=json.dumps(dict(_CFG, moe_dispatch="a2a")), x=x,
             y=np.asarray(want), aux_2=aux[2], aux_4=aux[4], **w,
             **{"g_" + k: np.asarray(v) for k, v in g.items()})
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "8", str(tmp_path / "store"),
         str(data), str(tmp_path / f"rank{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(8)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    errs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(8)]
    assert all(len(e) == 10 for e in errs)


def test_launch_train_under_the_host_mesh_matches_jax(tmp_path, monkeypatch,
                                                      capsys):
    """Both launchers resume from one checkpoint of the JAX package's
    initial state and run steps 1-3 of the same batches; the JAX launcher
    prints each loss to 4 decimals."""
    from repro.launch import train as jlaunch
    from repro.train import AdamWConfig as JAdamW
    from repro.train import AsyncCheckpointer as JCkpt
    from repro.train import init_state as jinit
    from repro.configs import get_config as jget_config
    from repro_torch.launch import train as launch

    steps, args = 3, ["--arch", "llama3.2-3b", "--reduced", "--global-batch",
                      "2", "--seq-len", "16", "--log-every", "1"]
    jcfg = jget_config("llama3.2-3b", reduced=True)
    ocfg = JAdamW(lr=3e-4, total_steps=steps, warmup_steps=1,
                  state_dtype=jcfg.opt_state_dtype)
    JCkpt(str(tmp_path / "jax"), keep=3).save(
        0, jinit(jax.random.PRNGKey(0), jcfg, ocfg), block=True)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")

    monkeypatch.setattr(sys, "argv", ["train", *args, "--steps", str(steps),
                                      "--ckpt-dir", str(tmp_path / "jax")])
    jlaunch.main()
    out = capsys.readouterr().out
    want = [float(line.split(" loss ")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")]
    assert len(want) == steps and "[resume] restored step 0" in out

    from repro_torch.train import data
    placed = []
    shard_batch = data.shard_batch

    def spy(batch, mesh, spec):
        out = shard_batch(batch, mesh, spec)
        placed.append((tuple(mesh.mesh_dim_names), tuple(spec),
                       type(out["tokens"]).__name__))
        return out

    monkeypatch.setattr(data, "shard_batch", spy)
    got = launch.main([*args, "--steps", str(steps), "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "port")])
    assert "[resume] restored step 0" in capsys.readouterr().out
    assert placed == [(("data", "model"), ("data", None), "DTensor")] * steps
    np.testing.assert_allclose(got, want, rtol=2e-4)
