"""Threaded pipeline (port of :mod:`beam_slam_tpu.pipeline.threaded`):
per-sensor spinner threads and a free-running optimizer thread — the
model-parallel runtime of the reference (SURVEY.md §2.7 / component #71:
every fuse AsyncSensorModel runs its callback queue on its own spinner
thread, and the fixed-lag smoother solves on a dedicated optimizer thread,
fixed_lag_smoother.cpp:166-311).

* one ``queue.Queue`` + daemon spinner thread per sensor stream (imu /
  lidar / camera / pose). Heavy per-scan work (feature extraction,
  registration on the card, LK tracking) runs on the owning spinner;
  PyTorch releases the GIL inside its kernels' launches and host ops, so
  streams overlap on those sections.
* the smoother serializes all graph access on its internal RLock (the
  pending-transaction mutex of the reference), and the optimizer thread
  ticks it at ``optimization_period`` — with ``async_solve`` the solve
  itself runs on the smoother's worker thread without holding the lock.
* cross-model calls (trigger → IMU constraint generation, frame-init pose
  queries, the ignition fan-out) are serialized on one model lock,
  mirroring the reference's trigger-topic indirection.

Sensor feeds (``on_imu``/``on_scan``/…) are non-blocking: a full queue
drops the OLDEST event (as a sensor feed does — stale sensor data is worthless)
and counts the drop. The IMU spinner runs the events queued so far under
one hold of the model lock (the reference takes it once per sample, which
a busy lidar spinner starves).

``tick()`` waits for the in-flight solve outside the model lock, on the
job's own completion (:meth:`solver.smoother._AsyncSolve.wait`), and reads
the smoother's in-flight handle under the smoother's lock (the reference
reads it without). A routed graph-update notification runs under the
smoother's lock too, so it sees the graph as its tick left it (the
reference's spinners read it unlocked, while the tick still ingests).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Callable, Optional

from beam_slam_tpu_torch.models.lidar_odometry import SlamChunk
from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper

_STREAMS = ("imu", "lidar", "camera", "pose")


class ThreadedLocalMapper(LocalMapper):
    """Drop-in LocalMapper whose sensor callbacks enqueue onto per-stream
    spinner threads. Call :meth:`start` to spin up, :meth:`stop` to join.
    ``join()`` blocks until every queued event has been processed (test
    and batch-replay barrier). With ``optimizer_thread=False`` nothing
    ticks on its own: the caller calls :meth:`tick`."""

    def __init__(self, config: LocalMapperConfig = LocalMapperConfig(),
                 chunk_cb: Optional[Callable[[SlamChunk], None]] = None,
                 device=None, queue_size: int = 4096,
                 optimizer_thread: bool = True):
        self._model_lock = threading.RLock()
        # set only after the FULL ignition fan-out: `init.initialized` flips
        # before the models are unblocked, so unlocked fast paths must key
        # on this flag instead
        self._ignited = False
        super().__init__(config, chunk_cb, device)
        self._queue_size = queue_size
        self._queues = {s: queue.Queue(maxsize=queue_size) for s in _STREAMS}
        self._unfinished = {s: 0 for s in _STREAMS}
        self._count_lock = threading.Lock()
        self.dropped = {s: 0 for s in _STREAMS}
        self.errors = {s: 0 for s in _STREAMS}
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._spin, args=(s,), daemon=True,
                             name=f"spinner-{s}") for s in _STREAMS]
        self._use_optimizer_thread = optimizer_thread
        if optimizer_thread:
            self._threads.append(threading.Thread(
                target=self._optimize_loop, daemon=True, name="optimizer"))
        self._started = False
        self._route_graph_updates()

    def _route_graph_updates(self):
        """Deliver each model's graph-update notification on that model's
        own spinner (fuse delivers onGraphUpdate to the plugin's callback
        queue) instead of inline on the optimizer thread — otherwise the
        optimizer would mutate lidar/visual model state concurrently with
        their spinners."""
        def stream_of(cb):
            owner = getattr(cb, "__self__", None)
            if owner is None:
                return None
            if owner is self.io or owner is getattr(self.io, "model", None):
                return "imu"
            if owner is self.lo or owner is getattr(
                    self.lo, "registration", None):
                return "lidar"
            if owner is self.vo:
                return "camera"
            return None

        def after_tick(cb):
            # the callback reads the graph under the smoother's lock, so it
            # sees the graph as the tick that fired it left it: the tick
            # still holds the lock while it ingests and dispatches after
            # the harvest, and a spinner that read ``slot_of_stamp`` in
            # between took the newest keyframe, not yet ingested, for a
            # marginalized one
            def run(sm):
                with self.smoother._lock:
                    cb(sm)
            return run

        routed = []
        for cb in self.smoother._on_update:
            s = stream_of(cb)
            if s is None:
                routed.append(cb)
            elif s == "imu":
                # imu-model state is shared with trigger/frame-init callers
                # → run under the model lock (taken before the smoother's,
                # the order of every other path)
                def locked_cb(sm, f=after_tick(cb)):
                    with self._model_lock:
                        f(sm)
                routed.append(lambda sm, f=locked_cb:
                              self._enqueue("imu", (f, (sm,))))
            else:
                routed.append(lambda sm, f=after_tick(cb), s=s:
                              self._enqueue(s, (f, (sm,))))
        self.smoother._on_update = routed

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ThreadedLocalMapper":
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def stop(self):
        """Drain, final tick, join all threads.

        After the spinners drain, tick the smoother until quiescent: under
        CPU contention the wall-clock optimizer thread may have run fewer
        cycles than the synchronous pipeline would, leaving transactions
        pending — shutdown must consume them (the reference's optimizer
        likewise drains its queue on stop)."""
        if not self._started:
            return
        self.join()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        self._started = False
        with self._model_lock:
            # full LocalMapper.flush: drains the pipelined-registration
            # device queue (factors still in flight) AND the async solve
            self.flush()
            for _ in range(64):  # bounded: each pass consumes the queue
                if not self.smoother._pending:
                    break
                self.smoother.run_once()
                self.smoother.flush()

    def join(self, timeout: Optional[float] = None):
        """Wait until every enqueued sensor event has been processed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for s in _STREAMS:
            while True:
                with self._count_lock:
                    done = self._unfinished[s] == 0
                if done:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"stream {s} still has work")
                time.sleep(0.002)

    # -- spinners -------------------------------------------------------------
    def _enqueue(self, stream: str, item):
        q = self._queues[stream]
        while True:
            try:
                q.put_nowait(item)
                with self._count_lock:
                    self._unfinished[stream] += 1
                return
            except queue.Full:
                try:
                    q.get_nowait()  # drop oldest
                    with self._count_lock:
                        self._unfinished[stream] -= 1
                    self.dropped[stream] += 1
                except queue.Empty:
                    pass

    def _spin(self, stream: str):
        q = self._queues[stream]
        while not self._stop.is_set():
            try:
                batch = [q.get(timeout=0.05)]
            except queue.Empty:
                continue
            if stream == "imu":
                # The IMU events queued so far run under ONE hold of the
                # model lock. One hold per sample starves this stream: the
                # lidar spinner holds the lock through each initialization
                # registration and takes it back at once, so a sample or
                # two got in per scan and the ignition waited for IMU
                # coverage it never got.
                while True:
                    try:
                        batch.append(q.get_nowait())
                    except queue.Empty:
                        break
                with self._model_lock:
                    self._run(stream, batch)
            else:
                self._run(stream, batch)

    def _run(self, stream: str, batch):
        for fn, args in batch:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — keep the spinner alive
                # A failing callback must not kill the stream (fuse callback
                # queues likewise survive a throwing plugin callback): count
                # it, log the first few, keep spinning.
                self.errors[stream] += 1
                if self.errors[stream] <= 3:
                    traceback.print_exc()
            finally:
                with self._count_lock:
                    self._unfinished[stream] -= 1

    def _optimize_loop(self):
        period = self.cfg.smoother_config().optimization_period
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(period)

    # -- sensor feeds (non-blocking producers) --------------------------------
    def on_imu(self, t, w, a):
        self._enqueue("imu", (self._imu_event, (t, w, a)))

    def on_scan(self, t, grid) -> bool:
        self._enqueue("lidar", (self._scan_event, (t, grid)))
        return True

    def on_image(self, t, image) -> bool:
        self._enqueue("camera", (self._image_event, (t, image)))
        return True

    def on_camera_measurement(self, meas) -> bool:
        self._enqueue("camera", (self._camera_event, (meas,)))
        return True

    def on_pose(self, t, q_wb, p_wb) -> bool:
        self._enqueue("pose", (self._pose_event, (t, q_wb, p_wb)))
        return True

    # -- spinner-side handlers -------------------------------------------------
    # IMU + init + ignition fan-out share the model lock; steady-state lidar/
    # camera processing runs unlocked on its own spinner (its cross-model
    # calls come back through the locked _trigger/_frame_init below).
    def _imu_event(self, t, w, a):
        with self._model_lock:
            super().on_imu(t, w, a)

    def _scan_event(self, t, grid):
        if not self._ignited:
            with self._model_lock:
                if not self._ignited:
                    super().on_scan(t, grid)
                    return
        super().on_scan(t, grid)

    def _image_event(self, t, image):
        if self.tracker is None:
            return
        meas = self.tracker.process_image(t, image)
        self._camera_event(meas)

    def _camera_event(self, meas):
        if not self._ignited:
            with self._model_lock:
                if not self._ignited:
                    super().on_camera_measurement(meas)
                    return
        super().on_camera_measurement(meas)

    def _pose_event(self, t, q_wb, p_wb):
        with self._model_lock:
            super().on_pose(t, q_wb, p_wb)

    # -- cross-model sections (called from lidar/camera spinners) -------------
    def _trigger(self, t):
        with self._model_lock:
            super()._trigger(t)

    def _frame_init(self, t):
        with self._model_lock:
            return super()._frame_init(t)

    def _on_initialized(self, result):
        with self._model_lock:
            super()._on_initialized(result)
            self._ignited = True

    # -- optimizer tick --------------------------------------------------------
    def tick(self):
        # Wait for the in-flight solve OUTSIDE the model lock: an optimizer
        # thread that held the lock through its blocking harvest would
        # starve every sensor spinner (they re-enter via
        # _trigger/_frame_init). Only this thread harvests, so the pre-wait
        # is safe; the handle is read under the smoother's lock.
        with self.smoother._lock:
            inflight = self.smoother._inflight
        if inflight is not None:
            inflight.wait()   # a worker's error surfaces at the harvest
        # the smoother's notify fan-out re-enters the IMU model
        # (update_from_graph) — take the model lock for the actual tick
        with self._model_lock:
            return super().tick()

    def reset(self):
        """Stop, then the system-wide reset protocol, keeping this mapper's
        queue size and optimizer-thread setting."""
        self.stop()
        with self._model_lock:
            self.__init__(self.cfg, self.chunk_cb, self.device,
                          self._queue_size, self._use_optimizer_thread)
