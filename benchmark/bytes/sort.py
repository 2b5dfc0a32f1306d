"""Bytes a sort needs: every key read once and written once (16 bytes a
u64 key), whatever sorts them."""


def necessary_bytes(shapes) -> int:
    return sum(rows * width for part in ("in", "out")
               for rows, width in shapes[part].values())
