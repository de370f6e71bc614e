"""``python -m repro_torch.calib`` — the measure → fit → artifact CLI."""
from repro_torch.calib.measure import main

if __name__ == "__main__":
    raise SystemExit(main())
