"""Launchers: profiling (``python -m repro_torch profile``), the design-space
sweep (``python -m repro_torch sweep``), serving and training."""


def parse_floats(csv: str) -> tuple:
    """``"0.5,1,2" -> (0.5, 1.0, 2.0)`` — the axis-flag parser of the sweep
    CLI."""
    return tuple(float(v) for v in csv.split(",") if v.strip())
