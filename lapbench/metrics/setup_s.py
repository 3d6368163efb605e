"""Set-up until the window opens (host clock), seconds."""


def read(rec):
    return rec["setup_s"]
