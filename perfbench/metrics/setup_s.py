"""Set-up: from the process's start to the window's: imports, loading the
kernels, compile, keygen, the first key pack, the request pool and the
warm-up."""


def read(records):
    return records["window"]["setup_s"]
