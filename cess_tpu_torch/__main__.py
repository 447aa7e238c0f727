"""`python -m cess_tpu_torch` → the node CLI (node/cli.py)."""

import sys

from .node.cli import main

# Guarded, unlike the JAX package's: the port's module walk imports this
# module, and an import must not start the CLI.
if __name__ == "__main__":
    sys.exit(main())
