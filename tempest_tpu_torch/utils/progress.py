"""Progress reporting (tempest_tpu/utils/progress.py, copied): a tqdm bar
with the run's diagnostics as its postfix when tqdm is importable, else
nothing is drawn."""

from __future__ import annotations

from typing import Any, Dict

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


class ProgressBar:
    """tqdm-based iteration progress with a live diagnostics postfix
    (beta, calls, ESS, logZ, logL, acc, steps, eff, K, CV)."""

    def __init__(self, show: bool = True, initial: int = 0):
        if tqdm is None:
            show = False
        # `enabled` gates the caller's stat collection: the postfix reads
        # about nine device scalars an iteration, each a host sync.
        self.enabled = bool(show)
        if tqdm is None:
            self.progress_bar = None
        else:
            self.progress_bar = tqdm(desc="Iter", disable=not show, initial=initial)
        self.info: Dict[str, Any] = dict()

    def update_stats(self, info: Dict[str, Any]) -> None:
        self.info = {**self.info, **info}
        if self.progress_bar is not None:
            self.progress_bar.set_postfix(ordered_dict=self.info)

    @property
    def count(self) -> int:
        """The iterations the bar shows."""
        return 0 if self.progress_bar is None else int(self.progress_bar.n)

    def update_iter(self, n: int = 1) -> None:
        """Move the bar `n` iterations on (one dispatch of the device run
        loop moves it by all the iterations the dispatch ran)."""
        if self.progress_bar is not None:
            self.progress_bar.update(n)

    def close(self) -> None:
        if self.progress_bar is not None:
            self.progress_bar.close()
