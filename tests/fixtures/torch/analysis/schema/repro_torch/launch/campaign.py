"""Minimal campaign tree for the schema-drift pin -> edit -> detect
round-trip (tests copy this to a tmp dir before pinning a manifest)."""

SCHEMA_VERSION = 1


class CampaignRunner:
    def _key(self, spec, backend):
        """The trace-cache key under test."""
        return f"v{SCHEMA_VERSION}:{spec.content_hash()}:{backend}"
