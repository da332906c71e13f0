"""A stdlib-only package, reached through the root all the same."""

import json


def plan(argv):
    return json.dumps(list(argv))
