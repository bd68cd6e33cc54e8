"""``tests/test_elastic_restore.py``'s protocol on the port, on one device:
train 2 steps, checkpoint through ``AsyncCheckpointer``, restore with
``restore_latest`` into a fresh state, train 1 more step, and match the
uninterrupted run's 3 losses at rtol 1e-5 (the reference test's
tolerance).  The checkpoint holds the state in the reference's layout
(``convert.train_state_to_reference``), so the JAX package reads it too:
its one further step from the restored state gives the port's third loss
within 2e-4 (one function by two paths, ``tests/test_archs.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train import (AdamWConfig, AsyncCheckpointer,  # noqa: E402
                               DataConfig, SyntheticCorpus, init_state,
                               make_train_step, restore_latest)

CPU = torch.device("cpu")
ARCH = "tinyllama-1.1b"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b"])
def test_checkpoint_restores_and_training_continues(arch, tmp_path):
    cfg = get_config(arch, reduced=True)
    ocfg = AdamWConfig(**OPT)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=8, seed=3))
    step = make_train_step(cfg, ocfg)

    def fresh():   # the state is updated in place: each run starts anew
        return init_state(torch.Generator().manual_seed(0), cfg, ocfg, CPU)

    def run_steps(state, n, start):
        losses = []
        for i in range(start, start + n):
            state, m = step(state, corpus.batch(i))
            losses.append(float(m["loss"]))
        return state, losses

    _, ref_losses = run_steps(fresh(), 3, 0)

    part, l01 = run_steps(fresh(), 2, 0)
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(2, convert.train_state_to_reference(part), block=True)
    del part
    step_no, host = restore_latest(str(tmp_path),
                                   convert.train_state_to_reference(fresh()))
    assert step_no == 2
    restored = convert.train_state_from_reference(cfg, host, CPU)
    assert int(restored.opt.step) == 2
    _, l2 = run_steps(restored, 1, 2)
    np.testing.assert_allclose(l01 + l2, ref_losses, rtol=1e-5)

    # the JAX package resumes the same checkpoint
    jcfg = j_get_config(arch, reduced=True)
    like = jax.tree.map(np.asarray, jtrain.init_state(
        jax.random.PRNGKey(0), jcfg, jtrain.AdamWConfig(**OPT)))
    jstep_no, jhost = jtrain.restore_latest(str(tmp_path), like)
    assert jstep_no == 2
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**OPT)))
    _, jm = jstep(jax.tree.map(jnp.asarray, jhost),
                  {k: jnp.asarray(v) for k, v in corpus.batch(2).items()})
    np.testing.assert_allclose(float(jm["loss"]), l2[0], rtol=2e-4)
