"""The sharded dry run under every named rule table
(``parallel.sharding.RULE_VARIANTS``) on a fake (2, 2) mesh: a training
step with two microbatches of the reduced hybrid (attention and the SSD
block) and MoE configs traces, and records collectives.  Each table
reaches a layout the defaults do not: ``sp`` splits the residual stream
along the sequence, ``dp`` puts the batch on every rank (a microbatch of
two over four ranks), ``moe_ep`` gives the tensor axis to the data ranks
that the batch holds too, and the serving tables leave one row of a
microbatch on each data rank."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import Shape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.parallel.sharding import RULE_VARIANTS  # noqa: E402

LAYERS = {"zamba2-2.7b": dict(n_layers=2, attn_every=2),
          "phi3.5-moe-42b-a6.6b": dict(n_layers=1)}


@pytest.mark.parametrize("variant", ["sp", "dp", "moe_ep", "serve_wg", "serve_repl"])
@pytest.mark.parametrize("arch", list(LAYERS))
def test_train_step_traces_under_each_rule_table(arch, variant):
    import torch.distributed as dist

    cfg = get_config(arch, reduced=True).replace(**LAYERS[arch])
    shape = Shape("reduced_train", 16, 4, "train")
    res = dryrun.run_cell(arch, shape.name, "pod", rules=RULE_VARIANTS[variant],
                          accum_steps=2, tag=variant, variant=variant,
                          device="cpu", cfg=cfg, shape=shape, mesh_shape=(2, 2))
    assert not dist.is_initialized()
    assert res["ok"] and res["tag"] == variant
    assert sum(res["collectives"]["count_by_kind"].values()) > 0
    mem = res["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] > 0
