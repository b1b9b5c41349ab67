"""Data pipeline of the port: synthetic and memmapped token sources and a
prefetching thread (the port of ``repro/data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    MemmapSource,
    Prefetcher,
    SyntheticSource,
    write_token_file,
)
