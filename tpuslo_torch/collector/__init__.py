"""Collectors of the port: the live HBM sampler, the parts of the native
ring runtime it writes through, and the deterministic synthetic samples
the signal generator expands (the port's own copies of
``tpuslo/collector/{hbm_sampler,native,ringbuf,synthetic}.py``)."""
