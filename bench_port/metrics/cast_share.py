"""PyTorch's copy kernels (the f32 -> bf16 cast of every weight at every
call, the cache splices and layout copies) over all device time in the
profiled slice, in %."""


def read(run):
    if run.slice is None:
        return None
    kinds = run.slice.by_kind()
    total = sum(kinds.values())
    return 100.0 * kinds.get("cast/copy", 0.0) / total if total > 0 \
        else None
