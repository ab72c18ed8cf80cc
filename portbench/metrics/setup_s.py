"""setup_s: seconds from the process's start to the first timed instant (host clock)."""


def read(rec):
    return rec.get("setup_s")
