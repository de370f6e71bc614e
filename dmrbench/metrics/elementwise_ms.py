"""Device time in PyTorch's elementwise kernels (by name) a step of the
traced window, ms."""


def read(rec):
    t = rec["trace"]
    if not t["steps"]:
        return None
    return 1e3 * t["elementwise_s"] / len(t["steps"])
