"""decode_tokens_per_s: the query tokens that finished every layer in the
window (batch x nq x steps), over the window's seconds on the host clock."""


def read(w):
    return w.tokens / w.window_s
