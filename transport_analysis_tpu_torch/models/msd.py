"""Einstein MSD: not ported yet (ROADMAP.md queue 1 item 2)."""

from ..utils.errors import not_ported


class EinsteinMSD:
    """Placeholder for ``transport_analysis_tpu.EinsteinMSD``: raises
    ``NotImplementedError`` naming the ROADMAP.md item that ports it."""

    def __init__(self, *args, **kwargs):
        raise not_ported("EinsteinMSD", "msd")
