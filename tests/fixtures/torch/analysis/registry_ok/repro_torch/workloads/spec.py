"""Alias map mirroring exactly what the backend decorators declare."""

_BACKEND_ALIASES = {
    "fast": "sim",
}
