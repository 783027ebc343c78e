"""Share of its roofline that the FFT path's device work reaches: the
least time of the window's FFT-path requests (``work.least_time``, from
their shapes) over the summed time of every kernel (no copy, no memset)
that ran inside those requests' spans, in %."""

from perfbench import roofline


def read(record):
    return roofline.share(record, fft=True)
