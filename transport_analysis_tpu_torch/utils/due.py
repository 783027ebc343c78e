"""Citation registry shim (duecredit-compatible no-op).

Counterpart of ``transport_analysis_tpu/utils/due.py``, for the
reference's ``due.py`` stub: modules declare citations
(``due.cite(Doi(...), ...)``) without requiring the optional
``duecredit`` package. If duecredit is installed it is used; otherwise
every call is a silent no-op.
"""

from __future__ import annotations


class _InactiveCollector:
    """Accepts any decorator/method usage and does nothing."""

    def _noop(self, *args, **kwargs):
        pass

    def _passthrough_decorator(self, *args, **kwargs):
        def decorate(func):
            return func

        return decorate

    cite = load = add = _noop
    dcite = _passthrough_decorator

    def __repr__(self):
        return f"{self.__class__.__name__}()"


def _id(x):
    return x


try:  # pragma: no cover - optional dependency
    from duecredit import due, Doi, BibTeX, Url  # type: ignore
except ImportError:  # pragma: no cover
    due = _InactiveCollector()
    Doi = BibTeX = Url = _id

# register the package-level citations once
due.cite(
    Doi("10.21105/joss.00877"),
    description="FFT autocorrelation algorithm (tidynamics)",
    path="transport_analysis_tpu_torch.ops.acf",
    cite_module=True,
)
