"""chip_smoke.py on the CPU: it must refuse to run without a GPU (and
without the package beside it), and its oracle comparisons must catch
what they are there to catch."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(script, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    res = _run(REPO / "chip_smoke.py", REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_refuses_to_run(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _tone_db(nfft=256, ncol=3, floor_db=-70.0):
    db = np.full((nfft, ncol, 1), floor_db)
    db[40] = 0.0
    db[39] = db[41] = -20.0
    return db


def test_compare_db_passes_within_budget_and_reports_max():
    want = _tone_db()
    got = want + 0.01
    assert chip_smoke.compare_db(got, want) == pytest.approx(0.01)


def test_compare_db_fails_beyond_budget():
    want = _tone_db()
    got = want.copy()
    got[39, 1, 0] += 0.2
    with pytest.raises(AssertionError, match="max \\|dB diff\\|"):
        chip_smoke.compare_db(got, want, what="x")


def test_compare_db_ignores_bins_deeper_than_the_window():
    """Bins more than 60 dB under their column's peak carry float32
    rounding of the peak's energy, not signal; they are not compared."""
    want = _tone_db(floor_db=-90.0)
    got = want.copy()
    got[100] += 3.0                      # 90 dB down: ignored
    assert chip_smoke.compare_db(got, want) == 0.0
    with pytest.raises(AssertionError):
        chip_smoke.compare_db(got, want, within_db=95.0)


def test_compare_db_rejects_shape_and_nonfinite():
    want = _tone_db()
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.compare_db(want[:, :2], want)
    bad = want.copy()
    bad[0, 0, 0] = np.nan
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.compare_db(bad, want)


def test_check_peaks_and_median_exact():
    freqs = np.fft.fftshift(np.fft.fftfreq(256, 1 / 10e6))
    med = np.full((256, 2), -80.0)
    med[np.argmin(np.abs(freqs - 1.25e6)), 0] = 0.0
    med[np.argmin(np.abs(freqs + 2.5e6)), 1] = 0.0
    assert chip_smoke.check_peaks(med, freqs, chip_smoke.TONES_HZ) == [160,
                                                                       64]
    with pytest.raises(AssertionError, match="peak bin"):
        chip_smoke.check_peaks(med[:, ::-1], freqs, chip_smoke.TONES_HZ)
    p = np.random.default_rng(0).exponential(size=(8, 3)).astype(np.float32)
    chip_smoke.check_median_exact(p, np.median(p, axis=0))
    with pytest.raises(AssertionError):
        chip_smoke.check_median_exact(p, np.median(p, axis=0) * 1.0000001)
