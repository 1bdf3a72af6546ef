"""Command-line drivers mirroring the reference executables."""
