"""Deterministic streaming RAG chat service on the port — the observed
workload (the counterpart of ``demo/rag_service``).

It serves the port's Llama and Mixtral engines (:mod:`tpuslo_torch.models`)
on the card, with a deterministic stub backend, streams NDJSON tokens,
records OTel-style spans (``chat.request`` → ``chat.retrieval`` →
``chat.generation``), exports Prometheus histograms, and demonstrates span
self-correlation against kernel signals via the port's correlator.
"""
