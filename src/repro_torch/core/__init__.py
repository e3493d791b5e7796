"""Core of the port: layouts, n:m:g conversion, sparsifiers, builder."""
