"""The port's entry points (``photon_ml_tpu_torch.entry``) against the JAX
package's ``__graft_entry__`` (CPU): ``entry()`` scores the same seeded batch
to the JAX forward step's means at the ``elementwise`` tolerance of
tests/tolerances.py, and the multihost dry run brings up gloo ranks that agree
bitwise and round-trip a multihost checkpoint."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as jentry  # noqa: E402
from photon_ml_tpu_torch import entry  # noqa: E402
from tolerances import assert_allclose  # noqa: E402


def test_entry_matches_the_jax_entry():
    jfn, (jw, jbatch) = jentry.entry()
    tfn, (tw, tbatch) = entry.entry("cpu")
    assert tuple(tbatch.features.matrix.shape) == (entry.N, entry.D) == (1024, 256)
    assert np.asarray(jbatch.features.matrix).tobytes() == tbatch.features.matrix.numpy().tobytes()
    assert np.asarray(jbatch.labels).tobytes() == tbatch.labels.numpy().tobytes()
    assert_allclose(tfn(tw, tbatch).numpy(), np.asarray(jfn(jw, jbatch)), kind="elementwise")


def test_entry_matches_the_jax_entry_at_nonzero_coefficients():
    import jax.numpy as jnp

    w = np.random.default_rng(3).normal(scale=0.1, size=entry.D).astype(np.float32)
    jfn, (_, jbatch) = jentry.entry()
    tfn, (_, tbatch) = entry.entry("cpu")
    got = tfn(torch.from_numpy(w), tbatch).numpy()
    assert_allclose(got, np.asarray(jfn(jnp.asarray(w), jbatch)), kind="elementwise")
    assert np.all((got > 0.0) & (got < 1.0))


def test_entry_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card refusal cannot be exercised")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()


def test_dryrun_multihost_two_gloo_ranks_agree(capsys):
    entry.dryrun_multihost(2, device="cpu")
    assert "ranks agree bitwise, checkpoint round-tripped" in capsys.readouterr().out


def test_dryrun_multichip_is_the_multihost_dry_run(monkeypatch):
    seen = []
    monkeypatch.setattr(entry, "dryrun_multihost", lambda n, device="cuda": seen.append(
        (n, device)))
    entry.dryrun_multichip(3)
    entry.dryrun_multichip(3, device="cpu")
    assert seen == [(3, "cuda"), (3, "cpu")]  # on the card unless asked for the CPU


def test_a_failed_rank_raises(monkeypatch):
    """A rank that cannot come up fails the dry run loudly."""
    with pytest.raises(RuntimeError, match="multihost dry run failed"):
        entry.dryrun_multihost(2) if not torch.cuda.is_available() else \
            entry.dryrun_multihost(2, device="bogus")
