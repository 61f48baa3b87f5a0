"""Bytes a codec call has to move at least: its input read once and its
output written once (a compress call: the data and the frame; a decompress
call: the frame and the data), whatever implements it."""


def call_bytes(call) -> int:
    return call.n_in + call.n_out
