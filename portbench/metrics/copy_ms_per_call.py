"""Transfer: device time of the host-to-device and device-to-host copies
per entry call (the packed inputs in, the outputs out)."""


def read(tr):
    ms = sum(d for name, _, d in tr.copies if "HtoD" in name or "DtoH" in name) * 1e-3
    if not tr.calls or not ms:
        return None
    return ms / tr.calls
