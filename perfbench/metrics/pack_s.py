"""Host clock around the first pack of the keys for the card (the pack
the window runs on), ending in a synchronise; on several cards rank 0's."""


def read(records):
    return records["setup"].get("pack_s")
