"""The ``zamba2-7b`` cell on the CPU at tiny sizes: its files load, its K3
reader reads synthetic raw data, the plain reference follows the port (loss, every gradient, an AdamW step) and
``transformers``' Zamba2 (logits), and the cell's run is correct when sound
and not when a fault or the control takes the program's place."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from insitu_bench import run  # noqa: E402
from insitu_bench.drivers import insitu_train_zamba2 as drv  # noqa: E402
from insitu_bench.lib import inputs, spec  # noqa: E402
from insitu_bench.lib.devtrace import Trace  # noqa: E402
from insitu_bench.reference import zamba2 as ref  # noqa: E402

CELL = "zamba2-7b.insitu_train_4k"
SEED = 2**33 + 29
H100 = "NVIDIA H100 80GB HBM3"
CPU = torch.device("cpu")


def shrink(config, traffic=None):
    """The configuration cut, in place, to 6 layers of width 64 with calls at
    layers 1, 2, 4 and 5 (blocks A, B, A, B), 2 groups, adapter rank 8."""
    config.update(hidden_size=64, num_hidden_layers=6, hybrid_layer_ids=[1, 2, 4, 5],
                  num_attention_heads=4, attention_head_dim=32, intermediate_size=96,
                  adapter_rank=8, mamba_d_state=16, mamba_headdim=16, chunk_size=32)
    config["run"]["vocab"] = 256
    if traffic is not None:
        traffic.update(seq=64, eval_seq=64, token_vocab=250)
    return config


def tiny_cell():
    cell = spec.load_cell(CELL)
    shrink(cell.config, cell.traffic)
    return cell


def _port_model(cfg, seed, **kw):
    from repro_torch.models.registry import get_family

    mcfg = drv.port_config(cfg).replace(**kw)
    model = get_family(mcfg).model(mcfg, CPU)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in drv.zamba2_weights(seed, drv.widths(cfg), "cpu"):
            params[name].copy_(t)
    return model, mcfg


# --------------------------------------------------------------- the files
def test_the_cell_loads_with_its_files():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "insitu_train_zamba2"
    assert (cell.traffic["batch"], cell.traffic["seq"]) == (1, 4096)
    assert set(cell.workload["limits"]) == {"grad_gap", "change_gap",
                                            "snapshot_mismatches"}
    w = drv.widths(cell.config)
    assert w["hybrid_layers"] == [6, 11, 17, 23] and w["n_layer"] == 27
    assert w["heads"] * w["head_dim"] == 2 * w["d_model"]
    names = {m["name"] for m in cell.per_layer}
    assert {"ssd_roofline", "train.mfu", "insitu.snapshot_ms",
            "device.idle_share.train"} <= names
    assert os.path.exists(os.path.join(spec.HERE, "metrics", "attn_roofline.py"))
    from repro_torch.configs import get_config

    mcfg = drv.port_config(cell.config)
    assert mcfg == get_config("zamba2-7b").replace(loss_chunk=mcfg.loss_chunk)
    n = sum(__import__("math").prod(s) for _, s, *_ in drv.zamba2_leaves(w))
    assert abs(n / 2.97e9 - 1) < 0.005


# ------------------------------------------------------------- the readers
def test_attn_roofline_reads_the_k3_launches():
    work = drv.rz.attn_work(1, 4096, 32, 224)
    raw = {"trace": Trace(0.0, 10.0, [("fa_wgmma_kernel<224>", 1.0, 1.001),
                                      ("fa_wgmma_kernel<224>", 2.0, 2.001),
                                      ("ssd_tc_kernel<2>", 3.0, 3.5)]),
           "device_name": H100, "attn_work": {"fa_wgmma_kernel": work}}
    bound = work[0] / 989e12                       # operations bound it
    got = spec.reader("attn_roofline").read(raw)
    assert got == pytest.approx(100 * 2 * bound / 0.002)
    assert spec.reader("attn_roofline").read({**raw, "device_name": "cpu"}) is None
    assert spec.reader("attn_roofline").read({"trace": raw["trace"],
                                              "device_name": H100}) is None


def _tool(name):
    import importlib.util

    sp = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def test_run_with_readers_adds_undeclared_readers_to_the_run(monkeypatch):
    """``tools/run_with_readers.py`` adds ``attn_roofline`` (undeclared: its
    unit given) and a reader declared for another cell (its unit kept) to
    the cell the run loads, and puts ``spec.load_cell`` back after."""
    tool = _tool("run_with_readers")
    declared = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    with pytest.raises(ValueError, match="NAME:UNIT"):
        tool.extra_metrics(["attn_roofline"], declared)
    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        seen["cell"] = {m["name"]: m["unit"] for m in spec.load_cell(CELL).per_layer}
        return 0

    monkeypatch.setattr(run, "main", fake_main)
    real = spec.load_cell
    argv = ["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "1"]
    assert tool.main(["--reader", "attn_roofline:%", "--reader",
                      "train.forward_ms", "--", *argv]) == 0
    assert seen["argv"] == argv
    assert seen["cell"]["attn_roofline"] == "%"
    assert seen["cell"]["train.forward_ms"] == "ms"
    assert "ssd_roofline" in seen["cell"] and spec.load_cell is real
    assert "attn_roofline" not in {m["name"] for m in spec.load_cell(CELL).per_layer}


# -------------------------------------------------- reference against port
def _names_and_grads(model, mcfg, batch):
    from repro_torch.models import zamba2

    loss = zamba2.loss_fn(model, mcfg, batch)
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("seq", [64, 50])     # whole chunks, and a short last one
def test_reference_loss_grads_and_step_match_the_port(seq):
    """In float32, with ``remat="full"`` and the kernels' CPU versions
    (``use_flash``), the port's loss, every leaf's gradient and the leaves
    after one AdamW step equal the reference's from the same weights and
    tokens, to float32 rounding: 2e-5 relative on the loss, 1e-4 of each
    gradient's norm (the two sum the same terms in other orders, and the
    shared blocks' gradients sum four calls); from the same gradients, one
    AdamW step of each (the decay rule, the clipping) to 1e-6."""
    from repro_torch.train import AdamWConfig
    from repro_torch.train.optim import adamw_init, adamw_update

    cfg = shrink(spec.load_cell(CELL).config)
    w = drv.widths(cfg)
    model, mcfg = _port_model(cfg, 5, dtype="float32", remat="full", use_flash=True)
    batch = inputs.token_batch(5, "train", 1, 2, seq, 250, "cpu")
    loss, grads = _names_and_grads(model, mcfg, batch)
    p = {n: t.detach().clone().requires_grad_() for n, t in model.named_parameters()}
    want = ref.loss(p, batch, w)
    want_grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=2e-5)
    for n, g in want_grads.items():
        assert (grads[n] - g).norm() <= 1e-4 * g.norm() + 1e-9, n
    o = spec.load_cell(CELL).config["optimizer"]
    ocfg = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                       warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                       min_lr_ratio=o["min_lr_ratio"])
    opt = adamw_init(model, ocfg)
    adamw_update(model, {n: g.clone() for n, g in want_grads.items()}, opt, ocfg)
    q = {n: t.detach().clone() for n, t in p.items()}
    m = {k: torch.zeros_like(t) for k, t in q.items()}
    v = {k: torch.zeros_like(t) for k, t in q.items()}
    ref.adamw(q, want_grads, m, v, 1, o, [])
    for n, t in model.named_parameters():
        torch.testing.assert_close(t.detach(), q[n], rtol=1e-6, atol=1e-6), n


def _recurrence(params, i, u, w):
    """Layer ``i``'s mixer on ``u`` with the SSD as a step-by-step
    recurrence over the positions (no chunks)."""
    m = f"layers.{i}.mamba."
    di = w["expand"] * w["d_model"]
    g, n, hd = w["ngroups"], w["d_state"], w["headdim"]
    heads = di // hd
    b, s, _ = u.shape
    z, xbc, dt = (u @ params[m + "in_proj"]).split([di, di + 2 * g * n, heads], -1)
    pad = torch.nn.functional.pad(xbc, (0, 0, w["d_conv"] - 1, 0))
    xbc = torch.nn.functional.silu(sum(pad[:, k:k + s] * params[m + "conv_w"][k]
                                       for k in range(w["d_conv"])) + params[m + "conv_b"])
    x, B, C = xbc.split([di, g * n, g * n], -1)
    x = x.reshape(b, s, heads, hd)
    B, C = (t.reshape(b, s, g, n).repeat_interleave(heads // g, 2) for t in (B, C))
    dt = torch.nn.functional.softplus(dt + params[m + "dt_bias"])
    a = -torch.exp(params[m + "A_log"])
    state, ys = torch.zeros(b, heads, n, hd), []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + B[:, t, :, :, None] * (x[:, t] * dt[:, t, :, None])[:, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", C[:, t], state))
    y = (torch.stack(ys, 1) + x * params[m + "D"][:, None]).reshape(b, s, di)
    y = ref.grouped_rmsnorm(y * torch.nn.functional.silu(z), params[m + "norm.scale"],
                            g, w["norm_eps"])
    return y @ params[m + "out_proj"]


def test_reference_mixer_follows_the_recurrence():
    """The reference's chunked scan over two chunks (the second short)
    equals the recurrence it stands for, in float32, to 1e-5 of the output's
    largest magnitude (sums in other orders)."""
    w = drv.widths(shrink(spec.load_cell(CELL).config))
    p = {n: t.float() for n, t in drv.zamba2_weights(4, w, "cpu")}
    u = torch.randn((2, 50, w["d_model"]), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = _recurrence(p, 0, u, w)
        got = ref.mamba(p, 0, u, w, "fp32")
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_reference_follows_transformers_zamba2():
    """The reference's logits equal ``transformers``' ``Zamba2ForCausalLM``
    (eager attention, CPU path) on the same weights, in float32, to 1e-4 of
    their spread.  ``time_step_min`` is set to 1e-30 there so that its CPU
    path's clamp of dt (which the card's path and the reference lack) never
    acts.  The 50 tokens lie in one chunk (``chunk_size`` 64 on both
    sides): that CPU path sums the decay between chunks over the wrong
    chunk index (``.sum(dim=2)``, l. 882; Mamba-2's transposes first), so
    between chunks it is not the published function, and the test above
    holds the reference's chunks to the recurrence instead."""
    os.environ.setdefault("USE_TF", "0")      # the import need not load TensorFlow
    transformers = pytest.importorskip("transformers")
    cfg = shrink(spec.load_cell(CELL).config)
    cfg["chunk_size"] = 64
    w = drv.widths(cfg)
    types = ["hybrid" if i in w["hybrid_layers"] else "mamba" for i in range(w["n_layer"])]
    hf_cfg = transformers.Zamba2Config(
        vocab_size=w["vocab"], hidden_size=w["d_model"], num_hidden_layers=w["n_layer"],
        layers_block_type=types, mamba_d_state=w["d_state"], mamba_d_conv=w["d_conv"],
        mamba_expand=w["expand"], mamba_ngroups=w["ngroups"],
        n_mamba_heads=w["expand"] * w["d_model"] // w["headdim"],
        chunk_size=w["chunk_size"], intermediate_size=w["d_ff"],
        num_attention_heads=w["heads"], num_mem_blocks=w["shared_blocks"],
        adapter_rank=w["adapter_rank"], use_shared_mlp_adapter=True,
        use_shared_attention_adapter=False, use_mem_rope=True,
        rope_theta=w["rope_theta"], rms_norm_eps=w["norm_eps"], time_step_min=1e-30,
        tie_word_embeddings=True, pad_token_id=0)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    hf = transformers.Zamba2ForCausalLM(hf_cfg).float().eval()
    p = {n: t.float() for n, t in drv.zamba2_weights(9, w, "cpu")}
    T = lambda name: p[name].T.contiguous()  # noqa: E731
    with torch.no_grad():
        hf.model.embed_tokens.weight.copy_(p["embed.tok"])
        hf.model.final_layernorm.weight.copy_(p["ln_f.scale"])
        c = 0
        for i, layer in enumerate(hf.model.layers):
            pre = f"layers.{i}."
            dec = layer.mamba_decoder if types[i] == "hybrid" else layer
            mx = dec.mamba
            dec.input_layernorm.weight.copy_(p[pre + "ln.scale"])
            mx.in_proj.weight.copy_(T(pre + "mamba.in_proj"))
            mx.conv1d.weight.copy_(p[pre + "mamba.conv_w"].T[:, None, :])
            mx.conv1d.bias.copy_(p[pre + "mamba.conv_b"])
            for n in ("A_log", "D", "dt_bias"):
                getattr(mx, n).copy_(p[pre + "mamba." + n])
            mx.norm.weight.copy_(p[pre + "mamba.norm.scale"])
            mx.out_proj.weight.copy_(T(pre + "mamba.out_proj"))
            if types[i] != "hybrid":
                continue
            blk, b = layer.shared_transformer, f"blocks.{c % w['shared_blocks']}."
            assert blk.block_id == c % w["shared_blocks"]
            for ours, theirs in (("wq", blk.self_attn.q_proj), ("wk", blk.self_attn.k_proj),
                                 ("wv", blk.self_attn.v_proj), ("wo", blk.self_attn.o_proj),
                                 ("gate_up", blk.feed_forward.gate_up_proj),
                                 ("down", blk.feed_forward.down_proj)):
                theirs.weight.copy_(T(b + ours))
            blk.input_layernorm.weight.copy_(p[b + "ln_in.scale"])
            blk.pre_ff_layernorm.weight.copy_(p[b + "ln_ff.scale"])
            adapter = blk.feed_forward.gate_up_proj_adapter_list[c]
            adapter[0].weight.copy_(T(f"calls.{c}.adapter_in"))
            adapter[1].weight.copy_(T(f"calls.{c}.adapter_out"))
            layer.linear.weight.copy_(T(f"calls.{c}.linear"))
            c += 1
        tokens = inputs.token_batch(9, "train", 1, 2, 50, 250, "cpu")["tokens"]
        theirs = hf(input_ids=tokens, use_cache=False).logits
        ours = ref.logits(p, tokens, w)
    assert c == 4 and hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    err = (ours - theirs).abs().max()
    assert err <= 1e-4 * theirs.std(), (float(err), float(theirs.std()))


# -------------------------------------------------------------- the cell
def _measure(cell, trace=False):
    return run.measure(cell, SEED, 0.5, trace, CPU, time.monotonic())


def test_sound_run_is_correct_and_reads_its_layers():
    result = _measure(tiny_cell(), trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert not {"ssd_roofline", "train.mfu"} & set(result["metrics"])  # no card: no peaks
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "altered", "snapshot"])
def test_train_fault_is_not_correct(monkeypatch, kind):
    """A state left unchanged, a zeroed gradient (the shared block A's
    query projection) and a snapshot altered in transit each fail the
    cell (half of the tokens is read at the cell's size on the card by
    ``controls/train_control_zamba2.py``: at this size it stays inside)."""
    import repro_torch.train.trainer as trainer
    from repro_torch.core.datamodel import Dataset

    real_update = trainer.adamw_update
    if kind == "unchanged":
        def update(model, grads, opt, cfg):
            zero = torch.zeros(())
            return dict(model.named_parameters()), opt, {"lr": zero, "grad_norm": zero}
        monkeypatch.setattr(trainer, "adamw_update", update)
    elif kind == "altered":
        def update(model, grads, opt, cfg):
            grads = {**grads, "blocks.0.wq": torch.zeros_like(grads["blocks.0.wq"])}
            return real_update(model, grads, opt, cfg)
        monkeypatch.setattr(trainer, "adamw_update", update)
    else:
        real_get = Dataset.__getitem__

        def get(self, key):
            out = real_get(self, key)
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                out = out.clone()
                out.view(-1)[0] += 1.0
            return out
        monkeypatch.setattr(Dataset, "__getitem__", get)
    result = _measure(tiny_cell())
    assert not result["correct"], result["checks"]


def test_control_and_zeroed_gradient_read_above_the_program():
    """The reference in float8 in the program's place reads at least three
    times what the sound program reads on one of the cell's numbers; the
    zeroed gradient reads as a leaf that never moved."""
    from insitu_bench.controls.train_control_zamba2 import readings

    rows = readings(tiny_cell(), SEED, CPU)
    assert [r["variant"] for r in rows] == ["control", "control", "half_batch", "zero_grad"]
    got = {**rows[0], **rows[1]}
    result = _measure(tiny_cell())
    program = {**{k: v["value"] for k, v in result["checks"].items()},
               "eval_loss_gap": result["readings"]["eval_loss_gap"]}
    assert any(got[k] > 3 * program[k] for k in ("grad_gap", "change_gap", "eval_loss_gap")), \
        (got, program)
    assert rows[3]["grad_gap"] == 1.0 and rows[3]["change_gap"] > 0.9
