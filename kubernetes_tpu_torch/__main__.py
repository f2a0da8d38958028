"""`python -m kubernetes_tpu_torch <component>` — the hyperkube entry
(ref: cmd/hyperkube/main.go:42)."""

import sys

from .hyperkube import main

sys.exit(main())
