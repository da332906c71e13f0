"""Prompt and generated tokens of every request completed in the window,
over the window's seconds (host clock)."""


def read(run):
    if not run.records or not run.window_s:
        return None
    tokens = sum(r["rows"] * (r["prompt_len"] + r["tokens"].shape[1])
                 for r in run.records)
    return tokens / run.window_s
