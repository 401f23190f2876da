"""Device ms a frame of every kernel but K1 and K3: the posed device
build, the bank gather and the compose."""

from bench_port.lib import kernels as K


def read(run):
    t = run.trace
    if t is None or not t.units or not t.kernels:
        return None
    other = sum(s for n, s in t.kernels if K.K1 not in n and K.K3 not in n)
    return other / t.units * 1e3
