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

Several processes must agree on one stop step before the next collective;
that agreement (an allgather of the flags every few steps) comes with data
parallelism, and until then ``should_stop`` raises in a multi-process run.
"""

from __future__ import annotations

import signal
import threading

from eovax_torch.core.device import process_count

# Module-level so nested or successive guards share one flag: a signal that
# arrives between two fit() calls must still stop the next one.
_flag = threading.Event()


class PreemptionGuard:
    """Context manager installing SIGTERM handlers.

    Handlers chain: the previously installed handler, if callable, runs after
    the flag is set. On exit the previous handlers are restored.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
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
        """True once training should stop; once True, stays True."""
        if self._stopped:
            return True
        if process_count() == 1:
            self._stopped = _flag.is_set()
            return self._stopped
        raise NotImplementedError(
            "agreeing on a stop step across processes is not ported yet: "
            "ROADMAP Queue 1 item 3d (torch.distributed)")


def reset_for_tests() -> None:
    _flag.clear()
