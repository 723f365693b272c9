"""Data substrate: synthetic vocabulary-mismatch corpus (numpy copy of ``repro.data``)."""
from repro_torch.data.synthetic import Corpus, CorpusConfig, generate_corpus  # noqa: F401
