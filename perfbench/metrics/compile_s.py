"""Host clock around the port's compile of the configuration's circuit."""


def read(records):
    return records["setup"].get("compile_s")
