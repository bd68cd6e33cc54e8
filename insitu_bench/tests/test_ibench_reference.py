"""The plain references against the port at tiny sizes on the CPU, and the
benchmark's import discipline: ``run.py`` refuses without a card, nothing
it or its drivers import is JAX or the JAX package, and the reference
imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from insitu_bench.drivers.insitu_train import port_config, widths  # noqa: E402
from insitu_bench.lib import inputs, spec  # noqa: E402
from insitu_bench.reference import mamba2 as ref  # noqa: E402

BENCH = os.path.join(ROOT, "insitu_bench")
BANNED = {"jax", "jaxlib", "ml_dtypes", "flax", "repro"}


def _tiny_mamba():
    cfg = spec.load_cell("mamba2-2.7b.insitu_train").config
    cfg.update(d_model=64, n_layer=2)
    cfg["mamba2_defaults"].update(d_state=16, headdim=16, chunk_size=32)
    cfg["run"].update(vocab=256, dtype="float32", remat="none")
    return cfg


def _port_model(cfg, seed):
    from repro_torch.models.ssm import MambaLM

    model = MambaLM(port_config(cfg), torch.device("cpu"))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in inputs.mamba2_weights(seed, widths(cfg), "cpu"):
            params[name].copy_(t)
    return model


@pytest.mark.parametrize("seq", [64, 50])     # whole chunks, and a short last one
def test_mamba2_reference_loss_and_grads_match_the_port(seq):
    """In float32 the reference's loss and every gradient equal the port's
    plain path (the same weights and tokens) to float32 rounding."""
    from repro_torch.models.ssm import loss_fn

    cfg = _tiny_mamba()
    w = widths(cfg)
    model = _port_model(cfg, 7)
    batch = inputs.token_batch(7, "train", 1, 2, seq, 250, "cpu")
    mcfg = port_config(cfg).replace(use_flash=False)
    port_loss = loss_fn(model, mcfg, batch)
    names = [n for n, _ in model.named_parameters()]
    port_grads = torch.autograd.grad(port_loss, list(model.parameters()))
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in model.named_parameters()}
    got = ref.loss(params, batch, w)
    grads = torch.autograd.grad(got, [params[n] for n in names])
    assert float(got.detach()) == pytest.approx(float(port_loss.detach()), rel=1e-5)
    for n, a, b in zip(names, grads, port_grads):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6), n


def test_mamba2_reference_adamw_matches_the_port():
    """One AdamW step of the reference equals the port's, bf16 leaves
    rounded as the port's parameters are."""
    from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update

    cfg = _tiny_mamba()
    cfg["run"]["dtype"] = "bfloat16"
    o = cfg["optimizer"]
    model = _port_model(cfg, 3)
    names = [n for n, _ in model.named_parameters()]
    g = torch.Generator().manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=g).to(p.dtype) * 1e-2
             for n, p in model.named_parameters()}
    params = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    ocfg = AdamWConfig(**{k: o[k] for k in o}, state_dtype="float32")
    adamw_update(model, grads, adamw_init(model, ocfg), ocfg)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    bf16 = [n for n, _, dt, _, _ in inputs.mamba2_leaves(widths(cfg)) if dt == "bfloat16"]
    ref.adamw(params, {n: t.float() for n, t in grads.items()}, m, v, 1, o, bf16)
    for n, p in model.named_parameters():
        assert torch.allclose(p.detach().float(), params[n], rtol=0, atol=1e-6), n
    assert names


def test_mamba2_reference_grad_hook_replaces_what_the_optimizer_gets():
    """``train``'s gradient hook: a leaf whose gradient it zeroes has no first
    gradient and moves by weight decay alone; the other leaves' first
    gradients are those of the run without the hook (clipping set out of
    reach, since the global norm changes with the zeroed leaf)."""
    cfg = _tiny_mamba()
    w, o = widths(cfg), {**cfg["optimizer"], "grad_clip": 1e30}
    batches = [inputs.token_batch(9, "train", s, 2, 64, 250, "cpu") for s in (1, 2)]
    leaf = "layers.1.mamba.in_proj"

    def zero(step, grads):
        return {**grads, leaf: torch.zeros_like(grads[leaf])}

    runs = []
    for hook in (None, zero):
        p = {n: t.float() for n, t in inputs.mamba2_weights(9, w, "cpu")}
        p0 = p[leaf].clone()
        losses, first = ref.train(p, batches, w, o, [], grad_hook=hook)
        runs.append((losses, first, p[leaf] - p0, p0))
    (l_a, f_a, _, _), (l_b, f_b, moved, p0) = runs
    assert l_a[0] == l_b[0] and f_b[leaf] == 0.0 and f_a[leaf] > 0
    assert all(f_b[n] == f_a[n] for n in f_a if n != leaf)
    lr = sum(ref.lr_at(o, s) for s in (1, 2))
    assert float(moved.norm()) <= 1.01 * lr * o["weight_decay"] * float(p0.norm())


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "mamba2-2.7b.insitu_train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_harness_imports_no_jax_nor_the_jax_package():
    """A fresh interpreter imports ``run.py``, every driver and every metric
    reader and finds none of JAX's or the JAX package's top-level names."""
    code = (
        "import sys, glob, os\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import insitu_bench.run\n"
        "from insitu_bench.lib import spec\n"
        f"for p in sorted(glob.glob({os.path.join(BENCH, 'drivers', '*.py')!r})):\n"
        "    spec.driver(os.path.basename(p)[:-3])\n"
        f"for p in sorted(glob.glob({os.path.join(BENCH, 'metrics', '*.py')!r})):\n"
        "    spec.reader(os.path.basename(p)[:-3])\n"
        "import repro_torch.core, repro_torch.models.ssm, repro_torch.train.trainer\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and not names & BANNED


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_reference_and_yardstick_import_nothing_of_the_port():
    """The reference, the inputs, the roofline and the readers import no
    ``repro_torch`` (nor JAX), by their sources and in a fresh interpreter."""
    files = [p for d in ("reference", "lib", "roofline", "metrics")
             for p in glob.glob(os.path.join(BENCH, d, "*.py"))]
    for path in files:
        assert not set(_imports(path)) & (BANNED | {"repro_torch"}), path
    code = (f"import sys; sys.path[:0] = [{ROOT!r}]\n"
            "import insitu_bench.reference.mamba2\n"
            "import insitu_bench.lib.inputs, insitu_bench.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & (BANNED | {"repro_torch"})


def test_inputs_repeat_by_seed_and_differ_across_seeds():
    a = inputs.token_batch(2**40 + 1, "train", 4, 2, 33, 100, "cpu")
    b = inputs.token_batch(2**40 + 1, "train", 4, 2, 33, 100, "cpu")
    c = inputs.token_batch(2**40 + 2, "train", 4, 2, 33, 100, "cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert not torch.equal(a["tokens"][0], a["tokens"][1])
    w = widths(_tiny_mamba())
    first = [t for _, t in inputs.mamba2_weights(2**40 + 1, w, "cpu")]
    again = [t for _, t in inputs.mamba2_weights(2**40 + 1, w, "cpu")]
    other = [t for _, t in inputs.mamba2_weights(2**40 + 2, w, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], other[0])
