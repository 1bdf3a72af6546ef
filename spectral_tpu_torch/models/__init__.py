"""Problem models: Poisson."""
