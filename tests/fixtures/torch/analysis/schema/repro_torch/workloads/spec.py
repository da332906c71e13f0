"""Minimal spec module holding the second pinned key function."""

import hashlib
import json


class WorkloadSpec:
    def content_hash(self):
        blob = json.dumps({"name": self.name}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()
