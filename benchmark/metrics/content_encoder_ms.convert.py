"""Device ms a request of the content encoder (models/content_encoder.py:
HuBERT and the prior transformer): the kernels launched inside its
forward, a completed request."""

from benchmark.metrics._read import per_request_ms


def read(rec):
    return per_request_ms(rec, "enc_p")
