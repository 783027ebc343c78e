"""Progress reporting for ``run(verbose=True)``.

Upstream MDAnalysis shows a tqdm ``ProgressBar`` over the frame loop
(SURVEY.md §5); this provides the same surface: tqdm when importable,
otherwise a dependency-free fallback with bar / percent / rate / ETA
on a single carriage-returned line.
"""

from __future__ import annotations

import sys
import time


class _FallbackBar:
    """Minimal tqdm-alike: ``update``, ``close``, iteration."""

    def __init__(self, iterable=None, total=None, desc="",
                 file=None, width: int = 24):
        self._iterable = iterable
        if total is None and iterable is not None:
            try:
                total = len(iterable)
            except TypeError:
                total = None
        self.total = total
        self.desc = desc
        self.n = 0
        self._t0 = time.perf_counter()
        self._last_draw = 0.0
        self._file = file or sys.stderr
        self._width = width

    def update(self, n: int = 1):
        self.n += n
        now = time.perf_counter()
        # redraw at most ~20x/s, always on the final item
        if (
            now - self._last_draw < 0.05
            and self.total is not None
            and self.n < self.total
        ):
            return
        self._last_draw = now
        elapsed = now - self._t0
        rate = self.n / elapsed if elapsed > 0 else 0.0
        if self.total:
            frac = min(1.0, self.n / self.total)
            filled = int(self._width * frac)
            bar = "#" * filled + "-" * (self._width - filled)
            eta = (self.total - self.n) / rate if rate > 0 else 0.0
            msg = (
                f"\r{self.desc}: {frac * 100:3.0f}%|{bar}| "
                f"{self.n}/{self.total} "
                f"[{elapsed:.1f}s<{eta:.1f}s, {rate:.1f} it/s]"
            )
        else:
            msg = (
                f"\r{self.desc}: {self.n} it "
                f"[{elapsed:.1f}s, {rate:.1f} it/s]"
            )
        print(msg, end="", file=self._file, flush=True)

    def close(self):
        if self.n:
            print(file=self._file, flush=True)

    def __iter__(self):
        for item in self._iterable:
            yield item
            self.update(1)
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def progress_bar(iterable=None, total=None, desc: str = "",
                 disable: bool = False):
    """tqdm when available, the fallback bar otherwise.

    ``disable=True`` returns the bare iterable (or a no-op updater),
    so call sites need no branching.
    """
    if disable:
        if iterable is not None:
            return iterable
        return _Noop()
    try:
        from tqdm.auto import tqdm

        return tqdm(iterable, total=total, desc=desc)
    except Exception:  # pragma: no cover - tqdm is in the test env
        return _FallbackBar(iterable, total=total, desc=desc)


class _Noop:
    def update(self, n: int = 1):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass
