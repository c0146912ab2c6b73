"""Pin the entry points in ``__graft_entry__`` so they can never silently
regress: ``entry()`` and ``dryrun_multichip`` must compile and run, and a
multi-device dry run must never hide a missing card behind a CPU mesh.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    sxx = np.asarray(out["sxx_dbfs"])
    med = np.asarray(out["sxx_med_dbfs"])
    assert sxx.shape == (16, 2, 4096)
    assert med.shape == (2, 4096)
    assert np.isfinite(sxx).all() and np.isfinite(med).all()


def test_dryrun_multichip_inline_8dev():
    # conftest forces an 8-device virtual CPU mesh, so the inline path runs.
    assert len(jax.devices()) >= 8
    graft.dryrun_multichip(8)


def test_dryrun_multichip_subprocess_path():
    # On the CPU backend a mesh larger than the visible devices is
    # simulated: dryrun_multichip re-launches under a forced virtual CPU
    # mesh (fresh interpreter, env-forced device count).
    assert jax.default_backend() == "cpu" and len(jax.devices()) < 16
    graft.dryrun_multichip(16)


def test_dryrun_multichip_raises_on_gpu_with_too_few_devices(monkeypatch):
    """On an accelerator the mesh must be real: too few cards is an error,
    never a quiet re-launch on the CPU."""
    import pytest

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    monkeypatch.setattr(graft, "_dryrun_subprocess", lambda n: pytest.fail(
        "fell back to a CPU re-launch"))
    with pytest.raises(RuntimeError, match="needs 4 gpu devices; 1 visible"):
        graft.dryrun_multichip(4)
