"""The demo's vector store on the port (the counterpart of
``demo/vectordb``): exact cosine top-k on the card."""

from tpuslo_torch.demo.vectordb.store import SearchHit, VectorStore, embed_text, embed_texts

__all__ = ["SearchHit", "VectorStore", "embed_text", "embed_texts"]
