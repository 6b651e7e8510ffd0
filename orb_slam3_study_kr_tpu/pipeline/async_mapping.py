"""Background mapping/loop worker — the reference's thread architecture.

The reference runs LocalMapping and LoopClosing on dedicated threads so
tracking never waits for triangulation/BA/loop work (System.cc:195-214);
keyframes are handed over through a queue (LocalMapping::InsertKeyFrame,
LocalMapping.cc:292-297).  This module is the equivalent here: one
worker thread drains a keyframe queue, running the mapper's stages and
the loop-closing cascade per keyframe.  Device work was already
asynchronous — what the worker buys is that the FRAME path no longer
blocks on the mapper's device fetches.

Consistency model (replaces the reference's mutex web, SURVEY.md section
5): every host section that reads or mutates the shared SoA map state —
in either thread — runs under the per-map re-entrant ``map.lock``
(Map::mMutexMapUpdate role).  Device dispatches are enqueued under the
lock but their *fetches* wait outside it, so the two threads interleave
around the link round trips.  Landmark/keyframe ids are monotonic (never
recycled), so a stale id read by the tracker is detected by the validity
masks rather than silently re-bound.

Cross-thread effects that would mutate TRACKER state (map merges, the
velocity reset after a loop correction) are not applied by the worker:
they are posted as events and applied by the tracker thread at the next
frame boundary (SlamSystem._drain_async_events) — the role of the
reference's mbResetRequested-style flag handshakes.
"""

import logging
import queue
import threading

log = logging.getLogger(__name__)


class AsyncMapping:
    """Single worker thread processing keyframe tasks in order."""

    def __init__(self, max_pending: int = 3):
        # Above max_pending queued keyframes the tracker blocks until the
        # worker catches up (bounded staleness; the reference instead
        # throttles via NeedNewKeyFrame's idle check, which the tracker
        # also mirrors — this cap is the hard backstop).
        self.max_pending = max_pending
        self._q = queue.Queue()
        self._events = []                  # ("loop"|"merge", payload)
        self._events_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._errors = []                  # every worker exception, in order
        self._errors_lock = threading.Lock()
        self.stats = {"n_processed": 0, "n_waits": 0, "n_errors": 0}
        self._thread = threading.Thread(
            target=self._run, name="slam-mapping", daemon=True)
        self._thread.start()

    # -- tracker side --------------------------------------------------
    def submit(self, fn):
        """Queue one keyframe task (a zero-arg callable built by the
        session; it runs mapper.run_once + the loop cascade)."""
        with self._pending_cv:
            while self._pending >= self.max_pending:
                self.stats["n_waits"] += 1
                self._pending_cv.wait(timeout=30.0)
            self._pending += 1
        self._idle.clear()
        self._q.put(fn)

    @property
    def busy(self) -> bool:
        """Reference LocalMapping 'not idle' — used by NeedNewKeyFrame to
        throttle keyframe insertion while the worker is behind."""
        return not self._idle.is_set()

    def post_event(self, kind, payload=None):
        with self._events_lock:
            self._events.append((kind, payload))

    def drain_events(self):
        with self._events_lock:
            ev, self._events = self._events, []
        return ev

    def pop_errors(self):
        """Worker exceptions since the last call (each was already logged
        at catch time).  Streaming sessions poll this at frame boundaries
        so a crashed mapping task surfaces within one frame instead of
        only at flush()."""
        with self._errors_lock:
            errs, self._errors = self._errors, []
        return errs

    def flush(self, timeout: float = 300.0):
        """Block until every queued task has completed (and re-raise the
        first worker crash, so tests fail loudly instead of silently losing
        the mapper)."""
        if not self._idle.wait(timeout=timeout):
            raise TimeoutError("async mapping worker did not drain")
        errs = self.pop_errors()
        if errs:
            raise errs[0]

    def shutdown(self):
        self._q.put(None)
        self._thread.join(timeout=30.0)

    # -- worker side ---------------------------------------------------
    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                break
            try:
                fn()
            except Exception as e:     # noqa: BLE001 — surfaced at the
                # next frame boundary (pop_errors) or at flush()
                log.exception("async mapping task failed")
                with self._errors_lock:
                    self._errors.append(e)
                self.stats["n_errors"] += 1
            finally:
                self.stats["n_processed"] += 1
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()
                    if self._pending == 0 and self._q.empty():
                        self._idle.set()
