#!/usr/bin/env python
"""End-to-end demo: synthesize -> view -> stream -> filter -> regenerate.

Produces the same kinds of artifacts the reference's example screenshots
show (reference: README.md:22-24, examples/*.png) from a synthetic
capture, entirely headless:

    python examples/demo.py /tmp/pstpu_demo

Writes: waterfall.png, psd.csv, stream.png, filtered WAV, and prints the
processor's event flow + latency stats.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

try:
    import pyspectrogram_tpu  # noqa: F401
except ImportError:  # run from a checkout without installing
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(outdir=None):
    outdir = outdir or tempfile.mkdtemp(prefix="pstpu_demo_")
    from pathlib import Path

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    from pyspectrogram_tpu.display import save_psd_csv, save_sti_png
    from pyspectrogram_tpu.io import RFDataset
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.models import StiPipeline
    from pyspectrogram_tpu.ops.filters import filter_signal, save_wav
    from pyspectrogram_tpu.runtime import ProcessorCallbacks, SpectrogramProcessor
    from pyspectrogram_tpu.utils import SpectrogramConfig
    from pyspectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    drf = out / "capture"
    print(f"[1/5] writing synthetic 2-tone capture -> {drf}")
    write_capture(drf, channel="demo", kind="tone", n_samples=1 << 20,
                  sample_rate_numerator=1_000_000, num_subchannels=2,
                  freqs_hz=[125_000.0, -300_000.0], noise_rms=3e-4)

    print("[2/5] one-shot STI + median PSD")
    ds = RFDataset(drf)
    cfg = SpectrogramConfig(nfft=4096, nint=2, ntime=128)
    res = StiPipeline(ds, cfg).compute()
    png = save_sti_png(str(out / "waterfall"), res.freqs, res.times,
                       res.sxx_dbfs[..., 0], colorrange=(-110, 0))
    csv = save_psd_csv(str(out / "psd"), res.freqs, res.sxx_med_dbfs[:, 0])
    peak = res.freqs[np.argmax(res.sxx_med_dbfs[:, 0])]
    print(f"      peak at {peak/1e3:+.1f} kHz -> {png}, {csv}")

    print("[3/5] processor loop (3 iterations over the event surface)")
    events = []
    proc = SpectrogramProcessor(
        "written", drf, tab_id=1, config=cfg,
        callbacks=ProcessorCallbacks(on_iterated=lambda e: events.append(e.i)),
        written_sleep=0.0, max_iterations=3,
    )
    proc.run()
    print(f"      iterations {events}, latency {proc.latency_stats()}")

    print("[4/5] incremental streaming through the on-device ring")
    from pyspectrogram_tpu.clients.cli import main as cli

    cli(["stream", str(drf), "--out", str(out / "stream.png"),
         "--nfft", "1024", "--cols-per-block", "8", "--ring-len", "128",
         "--renderer", "pixels"])

    print("[5/5] low-pass filter + audio regeneration")
    lo, hi = ds.bnds["demo"]
    x = ds.read(lo, 1 << 17, "demo")[:, 0]
    y = filter_signal(x, 1e6, "lowpass", 200_000.0, nfft=2048)
    wav = save_wav(str(out / "filtered"), y[2048:-2048], 48_000)
    print(f"      kept the +125 kHz tone, removed -300 kHz -> {wav}")
    print(f"done: artifacts in {out}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
