"""``python -m repro_torch.obs`` — the decision-audit CLI entry point."""
from repro_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main())
