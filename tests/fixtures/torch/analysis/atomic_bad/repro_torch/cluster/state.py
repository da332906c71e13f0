"""Violating twin: torn-write hazards in a cluster/ module."""

import json


def publish(path, payload):
    # raw write: a crash mid-dump leaves a half-written JSON file that
    # a concurrent reader parses as truncated state
    with open(path, "w") as f:
        json.dump(payload, f)


def publish_acknowledged(path, payload):
    # identical hazard, but deliberately waived inline: the suppression
    # mechanism must drop this finding and keep publish()'s
    with open(path, "w") as f:  # repro: allow(atomic-write)
        json.dump(payload, f)
