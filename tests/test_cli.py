"""CLI end-to-end: synth -> info -> sti -> psd -> filter round trips."""

import json
from pathlib import Path

import numpy as np
import pytest

from pyspectrogram_tpu.clients.cli import main


def _run(capsys, *argv):
    rc = main(list(argv))
    out = capsys.readouterr().out
    return rc, json.loads(out)


def test_synth_dtype_int16_streams(tmp_path, capsys):
    """synth --dtype int16 writes a raw integer capture (the receiver
    recording layout) and the stream path pushes its device blocks
    UNCONVERTED: the folded dBFS scale lands the 2^14 tone at exactly
    20*log10(2^-1.5) = -9.03 dBFS against the 2^15.5 int16 reference."""
    drf = tmp_path / "cap16"
    rc, meta = _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
                    "--n-samples", "65536", "--sample-rate", "1000000",
                    "--freqs", "125000", "--dtype", "int16")
    assert rc == 0 and meta["scale"] == 2 ** 14
    png = tmp_path / "s.png"
    rc, out = _run(capsys, "stream", str(drf), "--nfft", "512", "--nint",
                   "1", "--out", str(png))
    assert rc == 0 and png.exists()
    assert out["peak_dbfs"] == pytest.approx(-9.031, abs=0.05)


def test_synth_info_sti_psd(tmp_path, capsys):
    drf = tmp_path / "cap"
    rc, meta = _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
                    "--n-samples", "65536", "--sample-rate", "1000000",
                    "--freqs", "125000")
    assert rc == 0 and meta["channel"] == "ch0"

    rc, info = _run(capsys, "info", str(drf))
    assert rc == 0
    assert info["ch0"]["sample_rate"] == "1000000"
    assert info["ch0"]["entries"] == ["ch0:0"]
    assert info["ch0"]["start"].startswith("2016-01-01")

    png = tmp_path / "w.png"
    npz = tmp_path / "w.npz"
    rc, sti = _run(capsys, "sti", str(drf), "--out", str(png), "--npz",
                   str(npz), "--nfft", "512", "--ntime", "12",
                   "--renderer", "pixels")
    assert rc == 0 and png.exists() and npz.exists()
    assert sti["shape"] == [512, 12, 1]
    assert abs(sti["peak_dbfs"]) < 0.1  # full-scale tone ~ 0 dBFS

    arrs = np.load(npz)
    peak_f = arrs["freqs"][np.argmax(arrs["sxx_med_dbfs"][:, 0])]
    assert peak_f == pytest.approx(125000.0, abs=1000)

    csv = tmp_path / "p.csv"
    rc, psd = _run(capsys, "psd", str(drf), "--out", str(csv), "--nfft", "256",
                   "--ntime", "8")
    assert rc == 0 and csv.exists() and psd["nbins"] == 256

    # --t0/--t1 subset the saved time range (the GUI save sub-tab's
    # Start/End time fields; pixel renderer -> one row per kept column)
    full = tmp_path / "full.png"
    half = tmp_path / "half.png"
    _run(capsys, "sti", str(drf), "--out", str(full), "--nfft", "512",
         "--ntime", "12", "--renderer", "pixels")
    _run(capsys, "sti", str(drf), "--out", str(half), "--nfft", "512",
         "--ntime", "12", "--renderer", "pixels",
         "--t0", "0", "--t1", "0.03")
    from PIL import Image

    h_full = Image.open(full).size[1]
    h_half = Image.open(half).size[1]
    assert 0 < h_half < h_full

    # the subset applies to the npz sidecar too, not just the PNG
    # (advisor r3: the sidecar silently saved the full arrays before)
    half_npz = tmp_path / "half.npz"
    _run(capsys, "sti", str(drf), "--out", str(half), "--nfft", "512",
         "--ntime", "12", "--renderer", "pixels", "--npz", str(half_npz),
         "--t0", "0", "--t1", "0.03")
    cropped = np.load(half_npz)
    assert 0 < cropped["sxx_dbfs"].shape[1] < 12
    assert len(cropped["times"]) == cropped["sxx_dbfs"].shape[1]
    # ... but with no --frange the sidecar stays FULL-BAND: the config's
    # default ±1000 kHz display window must not silently drop bins from
    # a data export (this capture's band is ±500 kHz so nothing crops,
    # and an explicit --frange does crop)
    assert cropped["sxx_dbfs"].shape[0] == 512
    fr_npz = tmp_path / "fr.npz"
    _run(capsys, "sti", str(drf), "--out", str(half), "--nfft", "512",
         "--ntime", "12", "--renderer", "pixels", "--npz", str(fr_npz),
         "--frange", "-100", "100")
    fr = np.load(fr_npz)
    assert 0 < fr["sxx_dbfs"].shape[0] < 512
    assert np.all(np.abs(fr["freqs"]) <= 100e3)


def test_filter_roundtrip(tmp_path, capsys):
    drf = tmp_path / "cap2"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "32768", "--sample-rate", "1000000",
         "--freqs", "300000")
    out = tmp_path / "filtered"
    rc, res = _run(capsys, "filter", str(drf), "--out", str(out),
                   "--kind", "lowpass", "--cutoff", "100000",
                   "--nfft", "512")
    assert rc == 0
    # filtered channel readable; 300 kHz tone suppressed -> near silence
    from pyspectrogram_tpu.io import RFDataset

    ds = RFDataset(out)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    y = ds.read(lo, hi - lo + 1, chan)
    assert np.abs(y[512:-512]).max() < 1e-2


def test_cli_rejects_bad_args(tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["sti"])  # missing dataset
    with pytest.raises(SystemExit):
        main(["filter", str(tmp_path), "--out", "x", "--kind", "nope",
              "--cutoff", "1"])


def test_stream_command(tmp_path, capsys):
    drf = tmp_path / "cap3"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "65536", "--sample-rate", "1000000",
         "--freqs", "-250000")
    png = tmp_path / "s.png"
    rc, res = _run(capsys, "stream", str(drf), "--out", str(png),
                   "--nfft", "256", "--cols-per-block", "4",
                   "--ring-len", "64", "--renderer", "pixels")
    assert rc == 0 and png.exists()
    assert res["columns"] == 65536 // 256
    assert res["ring_columns"] == 64
    assert abs(res["peak_dbfs"]) < 0.1  # full-scale tone


def test_filter_wav_output(tmp_path, capsys):
    drf = tmp_path / "cap4"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "16384", "--sample-rate", "100000",
         "--freqs", "5000")
    rc, res = _run(capsys, "filter", str(drf), "--out", str(tmp_path / "f"),
                   "--kind", "lowpass", "--cutoff", "20000",
                   "--nfft", "256", "--wav", str(tmp_path / "audio"))
    assert rc == 0 and res["wav"].endswith(".wav")
    from scipy.io import wavfile

    rate, data = wavfile.read(res["wav"])
    assert rate == 100000 and len(data) > 15000


def test_session_save_and_resume(tmp_path, capsys):
    drf = tmp_path / "cap5"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "32768", "--sample-rate", "1000000",
         "--freqs", "100000")
    sess = tmp_path / "sess.npz"
    rc, a = _run(capsys, "sti", str(drf), "--out", str(tmp_path / "a.png"),
                 "--nfft", "512", "--ntime", "10", "--renderer", "pixels",
                 "--save-session", str(sess))
    assert rc == 0 and sess.exists()
    rc, b = _run(capsys, "resume", str(sess), "--out",
                 str(tmp_path / "b.png"), "--renderer", "pixels")
    assert rc == 0
    assert b["config"] == {"nfft": 512, "nint": 1, "ntime": 10,
                           "mode": "welch"}
    assert b["shape"] == a["shape"]
    # exact resume: identical request -> identical frame placement
    assert (tmp_path / "b.png").exists()
    # ... even after the capture GROWS: the saved sample_bounds pin the
    # frame starts (a None time_span would re-span the new full bounds)
    from pyspectrogram_tpu.io.synthetic import tone_signal
    from pyspectrogram_tpu.io.writer import DigitalRFWriter
    from pyspectrogram_tpu.runtime import checkpoint

    sess_meta = checkpoint.load_session(sess)
    w = DigitalRFWriter(
        drf, "ch0", np.complex64,
        start_global_index=1451661840 * 1_000_000 + 32768,
        sample_rate_numerator=1_000_000, file_cadence_millisecs=1000,
        subdir_cadence_secs=3600,
    )
    w.rf_write(tone_signal(32768, 1_000_000, [100000.0]).astype(
        np.complex64))
    rc, c = _run(capsys, "resume", str(sess), "--out",
                 str(tmp_path / "c.png"), "--renderer", "pixels")
    assert rc == 0
    assert c["frame_start0"] == sess_meta["sample_bounds"][0]
    assert c["frame_start0"] == b["frame_start0"]


def test_cli_one_sided_time_bounds(tmp_path, capsys):
    """--tstart without --tend (and vice versa) fills the open side from
    the dataset bounds instead of crashing in time_to_sample(None)."""
    drf = tmp_path / "cap6"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "32768", "--sample-rate", "1000000",
         "--freqs", "100000")
    rc, a = _run(capsys, "sti", str(drf), "--out", str(tmp_path / "a.png"),
                 "--nfft", "256", "--ntime", "6", "--renderer", "pixels",
                 "--tstart", "1451661840.005")
    assert rc == 0 and a["peak_dbfs"] > -5.0
    rc, b = _run(capsys, "psd", str(drf), "--out", str(tmp_path / "b.csv"),
                 "--nfft", "256", "--ntime", "6",
                 "--tend", "1451661840.02")
    assert rc == 0


def test_watch_command(tmp_path, capsys):
    drf = tmp_path / "cap6"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "131072", "--sample-rate", "1000000",
         "--freqs", "50000")
    png = tmp_path / "watch.png"
    rc, res = _run(capsys, "watch", str(drf), "--out", str(png),
                   "--nfft", "256", "--ntime", "8", "--window-s", "0.05",
                   "--refresh-s", "0.0", "--iterations", "3",
                   "--renderer", "pixels")
    assert rc == 0 and png.exists()
    assert res["iterations"] == 3
    assert res["latency"]["n"] == 3


def test_bench_e2e_smoke(tmp_path):
    """bench.py's e2e loop (disk -> assemble -> device -> STI with the
    prefetch feeder) runs end-to-end on a tiny capture."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    e2e_sps, host_sps, meta = bench.bench_e2e(
        gb=0.001, nfft=512, nint=1, ntime=32, nsub=1,
        cache_root=str(tmp_path), dtype="i16")
    assert e2e_sps > 0 and host_sps > 0
    assert meta["windows"] >= 1


def test_cli_sti_batch(tmp_path, capsys):
    """pstpu sti-batch renders one PNG per dataset from a single launch."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    for i in range(3):
        write_capture(tmp_path / f"d{i}", channel=f"c{i}", kind="tone",
                      n_samples=1 << 14, sample_rate_numerator=1_000_000,
                      freqs_hz=[125_000.0])
    out_dir = tmp_path / "pngs"
    out_dir.mkdir()
    rc = main([
        "sti-batch", *[str(tmp_path / f"d{i}") for i in range(3)],
        "--out-dir", str(out_dir), "--nfft", "512", "--ntime", "8",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["batched"] == 3
    for i, r in enumerate(info["results"]):
        assert (out_dir / f"d{i}.png").exists()
        assert abs(r["peak_dbfs"]) < 0.01  # full-scale tone


def test_cli_sti_batch_colliding_basenames(tmp_path, capsys):
    """Same-basename datasets must not overwrite each other's PNGs, and a
    missing --out-dir is created."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    for sub in ("day1", "day2"):
        write_capture(tmp_path / sub / "capture", channel="c0", kind="tone",
                      n_samples=1 << 14, sample_rate_numerator=1_000_000)
    out_dir = tmp_path / "new" / "dir"
    rc = main([
        "sti-batch", str(tmp_path / "day1" / "capture"),
        str(tmp_path / "day2" / "capture"),
        "--out-dir", str(out_dir), "--nfft", "512", "--ntime", "8",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pngs = {r["png"] for r in info["results"]}
    assert len(pngs) == 2  # distinct files
    for p in pngs:
        assert Path(p).exists()


def test_watch_checkpoint_resume(tmp_path, capsys):
    """watch --checkpoint persists the mid-stream state; --resume picks
    the stream up from the saved cursor instead of a cold window fill."""
    drf = tmp_path / "cap7"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "131072", "--sample-rate", "1000000",
         "--freqs", "50000")
    ck = tmp_path / "live.ckpt"
    rc, res = _run(capsys, "watch", str(drf), "--out",
                   str(tmp_path / "w1.png"), "--nfft", "256", "--ntime",
                   "8", "--window-s", "0.05", "--refresh-s", "0.0",
                   "--iterations", "2", "--renderer", "pixels",
                   "--checkpoint", str(ck))
    assert rc == 0 and res["checkpoint"].endswith(".npz")

    rc, res2 = _run(capsys, "watch", str(drf), "--out",
                    str(tmp_path / "w2.png"), "--nfft", "256", "--ntime",
                    "8", "--window-s", "0.05", "--refresh-s", "0.0",
                    "--iterations", "2", "--renderer", "pixels",
                    "--resume", res["checkpoint"])
    assert rc == 0 and (tmp_path / "w2.png").exists()
    assert res2["iterations"] == 2


def test_gui_command_headless_errors_as_json(capsys):
    """pstpu gui on a Qt-less host reports the install hint as the JSON
    error line instead of a traceback."""
    rc, res = _run(capsys, "gui")
    assert rc == 1 and "PyQt5" in res["error"]


def test_stream_command_with_hop(tmp_path, capsys):
    """stream --hop < nfft*nint pushes an OVERLAPPED stream: one column
    per hop samples (overlap-save), peak still at the tone."""
    drf = tmp_path / "cap_hop"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "65536", "--sample-rate", "1000000",
         "--freqs", "-250000")
    png = tmp_path / "sh.png"
    rc, res = _run(capsys, "stream", str(drf), "--out", str(png),
                   "--nfft", "256", "--hop", "128", "--cols-per-block", "4",
                   "--ring-len", "64", "--renderer", "pixels")
    assert rc == 0 and png.exists()
    assert res["columns"] == 65536 // 128  # 2x the contiguous column count
    assert res["ring_columns"] == 64
    assert abs(res["peak_dbfs"]) < 0.1


def test_watch_command_with_hop(tmp_path, capsys):
    """watch --hop runs the LIVE engine in overlap-save mode end-to-end."""
    drf = tmp_path / "cap_whop"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "131072", "--sample-rate", "1000000",
         "--freqs", "50000")
    png = tmp_path / "wh.png"
    rc, res = _run(capsys, "watch", str(drf), "--out", str(png),
                   "--nfft", "256", "--hop", "128", "--ntime", "8",
                   "--window-s", "0.01", "--refresh-s", "0.0",
                   "--iterations", "2", "--renderer", "pixels")
    assert rc == 0 and png.exists()
    assert res["iterations"] == 2


def test_stream_rejects_oversize_hop(tmp_path, capsys):
    drf = tmp_path / "cap_badhop"
    _run(capsys, "synth", "--out", str(drf), "--kind", "tone",
         "--n-samples", "16384", "--sample-rate", "100000")
    with pytest.raises(ValueError, match="hop"):
        main(["stream", str(drf), "--out", str(tmp_path / "x.png"),
              "--nfft", "256", "--hop", "512"])


def test_bench_multitab_smoke():
    """bench_multitab (the mtab/7/display info row) runs on CPU with tiny
    shapes: merged and solo cycles both measure, speedup is positive."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    m = bench.bench_multitab(B=2, nfft=128, ntime=8, iters=2)
    assert m["merged_ms"] > 0 and m["solo_ms"] > 0 and m["speedup"] > 0
