"""The demo workload on the port (the counterpart of the repo's ``demo/``):
the streaming RAG chat service whose ``chat.request`` ->
``chat.retrieval`` -> ``chat.generation`` spans the toolkit correlates,
served by the port's engines (:mod:`tpuslo_torch.demo.rag_service`), and
its vector store (:mod:`tpuslo_torch.demo.vectordb`)."""
