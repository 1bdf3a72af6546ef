"""`python -m spectral_tpu_torch.cli` == the `spectral-tpu-torch` console script."""

from spectral_tpu_torch.cli.main import main

raise SystemExit(main())
