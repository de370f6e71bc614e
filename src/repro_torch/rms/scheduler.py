"""The one value of ``repro.rms.scheduler`` the port needs: the priority a
wide-optimization shrink gives the queued job it lets start (§4.3)."""

MAX_PRIORITY = 1e12
