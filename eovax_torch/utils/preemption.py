"""Graceful-preemption guard for long training runs.

Port of ``eovax/utils/preemption.py``. Preemptible machines deliver SIGTERM
shortly before eviction. The trainer polls a signal-set flag once per step
and leaves the fit loop cleanly, which lands in its end-of-fit "save and
flush" path, so the resume point is the interrupted step, not the last
``ckpt_every`` multiple.

    with PreemptionGuard() as guard:
        for step, batch in ...:
            ...
            if guard.should_stop(step):
                break        # fit's tail saves the checkpoint

Under a process group every rank must leave the loop at the same step, or
the next collective hangs; a signal reaches the ranks at different times (or
one rank alone). ``should_stop`` therefore takes the MAX of the ranks' flags
(one all-reduce, on the card under NCCL) at the steps that ``sync_every``
divides, and the trainers pass ``sync_every=10``: the all-reduce waits for the
queued device work, so a per-step agreement would stall the host every step,
and the stop comes at most 10 steps after the signal. Without a group the
local flag is read at every call.
"""

from __future__ import annotations

import signal
import threading

from eovax_torch.parallel.mesh import any_rank, grouped

# Module-level so nested or successive guards share one flag: a signal that
# arrives between two fit() calls must still stop the next one.
_flag = threading.Event()


class PreemptionGuard:
    """Context manager installing SIGTERM handlers.

    Handlers chain: the previously installed handler, if callable, runs after
    the flag is set. On exit the previous handlers are restored.
    """

    def __init__(self, signals=(signal.SIGTERM,), sync_every: int = 1):
        self._signals = tuple(signals)
        self.sync_every = max(int(sync_every), 1)
        self._prev: dict[int, object] = {}
        self._stopped = False

    def __enter__(self) -> "PreemptionGuard":
        for sig in self._signals:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                _flag.set()
                if callable(_prev):
                    _prev(signum, frame)

            try:
                signal.signal(sig, _handler)
            except ValueError:
                # signal.signal works on the main thread only: off it the
                # guard stays inert (should_stop still sees a flag set by a
                # guard on the main thread).
                continue
            self._prev[sig] = prev
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            if prev is None:
                # A handler installed by non-Python code: signal.signal
                # rejects None, so ours stays.
                continue
            signal.signal(sig, prev)
        self._prev.clear()

    @staticmethod
    def signalled() -> bool:
        """This process's local flag."""
        return _flag.is_set()

    def should_stop(self, step: int | None = None) -> bool:
        """True once training should stop, the same on every rank; once True,
        stays True. Under a group the ranks' flags are OR-ed when ``step`` is a
        multiple of ``sync_every`` (or ``step`` is None), and every other call
        returns False."""
        if self._stopped:
            return True
        if not grouped():
            self._stopped = _flag.is_set()
            return self._stopped
        if step is not None and step % self.sync_every != 0:
            return False
        self._stopped = any_rank(_flag.is_set())
        return self._stopped


def reset_for_tests() -> None:
    _flag.clear()
