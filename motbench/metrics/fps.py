"""Frames of every stream read back a second, over the whole window
(which ends after a ``sync``)."""


def read(ctx):
    win = ctx.window
    return win["read"] / win["elapsed"]
