"""reopen_share.serve: the share of the untraced window's time that its
rounds' re-opens take on the host, in %: each round's `server.open_streams`
span (its sources' copies, `animator.begin`) and `graph.capture` span (the
eager warm-up steps and the capture), from the program's registry."""
from portbench import registry


def read(ctx):
    w = registry.window(ctx)
    if w is None:
        return None
    taken = sum(registry.span_s(r) for records in w["spans"].values() for r in records)
    return 100.0 * taken / w["elapsed_s"]
