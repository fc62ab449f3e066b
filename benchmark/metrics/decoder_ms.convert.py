"""Device ms a request of the HiFi-GAN decoder (models/hifigan.py): the
kernels launched inside the decoder's forward, a completed request."""

from benchmark.metrics._read import per_request_ms


def read(rec):
    return per_request_ms(rec, "dec")
