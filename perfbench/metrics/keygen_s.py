"""Host clock around the keygen from the seed, ending in a synchronise."""


def read(records):
    return records["setup"].get("keygen_s")
