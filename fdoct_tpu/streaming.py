"""High-rate streaming: overlapped host→device input pipeline.

The reference's fastest path is capture-then-save with a 500-frame buffer
(BscanFFTspinjnt.cpp:259-352) because its compute cannot keep up with the
camera; here the goal is inverted — keep the device busy while frames stream
in.  A producer thread (camera ring / replay / synthetic) fills a bounded
queue; the consumer assembles batches, issues an async ``device_put`` for
batch N+1 while batch N computes, and never blocks the device on the host
(the jax dispatch queue provides the overlap; this layer provides the
batching, prefetch, and backpressure).

This is the production shape of the BASELINE.md "500+ fps triggered-capture
emulation" workload.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import jax


@dataclass
class StreamStats:
    frames_in: int = 0
    batches_done: int = 0
    dropped: int = 0
    t_start: float = field(default_factory=time.monotonic)

    @property
    def fps(self) -> float:
        dt = time.monotonic() - self.t_start
        return self.frames_in / dt if dt > 0 else 0.0


class FrameStreamer:
    """Producer thread feeding a bounded frame queue.

    ``drop_oldest=True`` gives live-camera semantics (newest frame wins,
    like polling fdoct_ring's latest); False gives lossless replay
    semantics (producer blocks on backpressure).
    """

    def __init__(self, source_frames: Iterator[np.ndarray],
                 maxsize: int = 64, drop_oldest: bool = False,
                 rate_fps: float | None = None):
        self._it = source_frames
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.drop_oldest = drop_oldest
        self.rate_fps = rate_fps
        self.stats = StreamStats()
        self.error: BaseException | None = None   # producer death, surfaced
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "FrameStreamer":
        self._thread.start()
        return self

    def _run(self) -> None:
        period = 1.0 / self.rate_fps if self.rate_fps else 0.0
        next_t = time.monotonic()
        try:
            for frame in self._it:
                if self._stop.is_set():
                    break
                if frame is None:
                    # triggered CameraSource idling between pulses
                    # (camera.py frames() yields None instead of starving)
                    continue
                if period:
                    next_t += period
                    delay = next_t - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                while True:
                    try:
                        self.q.put_nowait(frame)
                        self.stats.frames_in += 1
                        break
                    except queue.Full:
                        if self.drop_oldest:
                            try:
                                self.q.get_nowait()
                                self.stats.dropped += 1
                            except queue.Empty:
                                pass
                        else:
                            if self._stop.wait(0.001):
                                return
        except BaseException as e:   # a dead source must not look like EOF
            self.error = e

    def get_batch(self, n: int, timeout_s: float = 10.0) -> np.ndarray | None:
        """Up to ``n`` frames (a short final batch when the producer ended
        with frames still queued); None on a clean end with nothing queued.
        Re-raises the producer's exception (e.g. the camera watchdog's
        TimeoutError) instead of masking it as a silent timeout."""
        frames = []
        deadline = time.monotonic() + timeout_s
        while len(frames) < n:
            try:
                frames.append(self.q.get(timeout=min(
                    0.2, max(0.0, deadline - time.monotonic()))))
            except queue.Empty:
                if self.error is not None:
                    raise self.error
                if not self._thread.is_alive() or time.monotonic() >= deadline:
                    break
        if not frames:
            return None
        return np.stack(frames)

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Signal the producer and wait for it to exit, so the caller can
        safely close the frame source (the ring mmap) afterwards."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)


def run_streaming(
    source_frames: Iterator[np.ndarray],
    step: Callable,                  # device fn: (frames_device) -> result
    batch: int,
    n_batches: int,
    rate_fps: float | None = None,
    drop_oldest: bool = False,
    device=None,
    sharding=None,
    put: Callable | None = None,
) -> tuple[list, StreamStats]:
    """Pump ``n_batches`` through ``step`` with transfer/compute overlap.

    Issues device_put + step for the next batch before blocking on the
    previous result — the minimal two-deep software pipeline.  Returns
    (results, stats); stats.fps is the end-to-end ingest rate.

    ``sharding``: a ``jax.sharding.NamedSharding`` (e.g. ``NamedSharding(
    mesh, P('data', 'ascan', None))``) places each batch across the mesh in
    ONE host→device_put — the ingest seam of the sharded B-scan steps
    (parallel.sharded; SURVEY §5's "input pipeline that device_puts
    interferogram batches", here batched across one host's chips).  When
    given, it wins over ``device``; ``batch`` and the frame rows must
    divide the mesh axes like ``parallel.shard_frames`` requires.

    ``put``: full override of the host→device placement, ``put(host_batch)
    -> device_array``.  The multi-host streaming path passes
    ``jax.make_array_from_process_local_data(global_sharding, ·)`` here so
    each process feeds ITS shard of a global array (examples/
    multihost_stream_cscan.py); single-host callers never need it.
    """
    device = sharding if sharding is not None else (device or jax.devices()[0])
    if put is None:
        put = lambda host: jax.device_put(host, device)  # noqa: E731
    streamer = FrameStreamer(source_frames, maxsize=4 * batch,
                             drop_oldest=drop_oldest, rate_fps=rate_fps).start()
    results: list = []
    inflight = None
    try:
        for _ in range(n_batches):
            host = streamer.get_batch(batch)
            if host is None:
                break
            dev_frames = put(host)
            out = step(dev_frames)
            if inflight is not None:
                inflight.block_until_ready()
                results.append(inflight)
            inflight = out
        if inflight is not None:
            inflight.block_until_ready()
            results.append(inflight)
        streamer.stats.batches_done = len(results)
        return results, streamer.stats
    finally:
        streamer.stop()
