"""Bytes read and written by the port's f32 -> bf16 casts (the
``copy.weight_cast`` counter of ``layers.cast``) in the profiled slice, in
MB (1e6 bytes), over the output tokens returned in it."""
from bench_port import spanview


def read(run):
    return spanview.mb_per_token(run, "copy.weight_cast")
