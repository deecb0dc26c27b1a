"""A compound (multi-op pipeline) request through the ROI service.

The port's twin of ``examples/roi_pipeline.py``. Every operator registers
under ``(op, device type)`` in the backend registry, requests pick one
with ``submit(mask, op=...)`` / ``POST /v1/{op}``, and an ordered op chain
can run as ONE device-resident compound request (``submit_pipeline`` /
``POST /v1/pipeline``) — no host round trip between stages, bit-identical
to issuing the stages as separate requests.

This example denoises a speckled float image (P-HGRMS-style hypergraph
RMS filter, op ``denoise``) and feeds the filtered image straight into
the yCHG ROI analysis (op ``ychg``), three ways:

  1. in-process single ops — ``submit(..., op="denoise")``, then
     ``submit`` of the result (two device round trips);
  2. in-process compound   — ``service.pipeline(img, ["denoise",
     "ychg"])`` (one submit, stages chained on the device);
  3. over the wire         — ``client.pipeline`` against the HTTP front
     end's ``POST /v1/pipeline``.

All three agree bit for bit, which the script asserts.

Run:  PYTHONPATH=src python -m repro_torch.examples.roi_pipeline [--device cpu]
"""

import numpy as np

from repro_torch.engine import Engine
from repro_torch.examples import parse_device
from repro_torch.frontend import ServerThread, YCHGClient
from repro_torch.service import Service, ServiceConfig


def speckled_image() -> np.ndarray:
    """A smooth field with salt-and-pepper speckle: the denoise stage's
    outlier test (|x - mean| > tau * rms) replaces the spikes."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:128]
    img = np.maximum(
        0.0, 0.55 * np.sin(yy / 9.0) * np.cos(xx / 13.0) - 0.05
    ).astype(np.float32)   # zero background between the lobes
    spikes = rng.random(img.shape) < 0.02
    img[spikes] = rng.random(spikes.sum()).astype(np.float32) * 4.0
    return img


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    img = speckled_image()
    config = ServiceConfig(bucket_sides=(128,), max_batch=4,
                           max_delay_ms=1.0)
    with Service(Engine(device=device), config) as service, \
            ServerThread(service) as server, \
            YCHGClient("127.0.0.1", server.port) as client:
        # 1. the stages as separate requests (host hop between them)
        filtered = service.submit(img, op="denoise").result(timeout=60)
        stage2 = service.submit(
            filtered.to_host()["image"],
            op="ychg").result(timeout=60).to_host()

        # 2. one compound request: denoise -> ychg chained on the device
        compound = service.pipeline(img, ["denoise", "ychg"],
                                    timeout=60).to_host()
        for field, want in stage2.items():
            assert np.array_equal(compound[field], want), field
        print("compound denoise+ychg == the stages as separate submits "
              f"({int(compound['n_hyperedges'])} hyperedges "
              "in the filtered image)")

        # 3. the same compound request over the HTTP front end
        wire = client.pipeline(img, ["denoise", "ychg"])
        for field, want in compound.items():
            assert np.array_equal(wire[field], want), field
        print("POST /v1/pipeline bit-identical to the in-process compound "
              "request")

        # the per-stage spans/histograms the compound request leaves
        # behind: one pipeline.<op> series per stage, keyed by the compound
        # bucket
        for line in client.metrics_text().splitlines():
            if line.startswith("ychg_stage_seconds_count") \
                    and "pipeline." in line:
                print(f"  /metrics  {line}")


if __name__ == "__main__":
    main()
