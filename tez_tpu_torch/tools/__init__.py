"""Tools of the port: the seeded query corpus (query_corpus.py)."""
