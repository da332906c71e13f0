"""Stale alias map: drifted from what the decorators declare."""

_BACKEND_ALIASES = {
    "fast": "other",   # decorator says "fast" -> "sim"
    "gone": "sim",     # no decorator declares "gone" at all
}
