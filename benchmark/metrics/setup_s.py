"""setup_s: seconds from the process's start to the end of the warm-up
request (torch, the CUDA context, the program's library, one request)."""


def read(run):
    return run["setup_s"]
