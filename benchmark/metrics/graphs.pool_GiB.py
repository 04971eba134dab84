"""graphs: the memory the compiled frame's graph pools hold at the
window's end (GraphCache.pool_bytes()), GiB."""


def read(run):
    if not run.pool_bytes:
        return None
    return run.pool_bytes / 2 ** 30
