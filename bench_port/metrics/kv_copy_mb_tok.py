"""Bytes read and written by the port's cache copies in the profiled
slice (``copy.kv_upcast``: decode attention's f32 copies of the KV caches;
``copy.cache_pad``: a prefill's caches padded to ``max_len``;
``copy.splice``: a prefill's caches copied into its slot), in MB (1e6
bytes), over the output tokens returned in it."""
from bench_port import spanview


def read(run):
    return spanview.mb_per_token(run, "copy.kv_upcast", "copy.cache_pad",
                                 "copy.splice")
