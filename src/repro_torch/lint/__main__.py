"""``python -m repro_torch.lint`` entry point."""
import sys

from repro_torch.lint.cli import main

sys.exit(main())
