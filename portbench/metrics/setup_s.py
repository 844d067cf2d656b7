"""Set-up seconds: from the process's start to the window's (host clock)."""


def read(r):
    return r["setup_s"]
