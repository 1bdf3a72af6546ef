"""Runtime utilities: options database and interop with the JAX package."""
