"""Real (unpadded) training images times seeds trained, over the host
clock of all the window's whole epochs, validation included."""


def read(m):
    return m.images / m.window_s
