"""Share of its roofline that the windowed path's device work (K8's lag
sums) reaches: the least time of the window's windowed requests
(``work.least_time``, from their shapes) over the summed time of every
kernel (no copy, no memset) that ran inside those requests' spans, in
%."""

from perfbench import roofline


def read(record):
    return roofline.share(record, fft=False)
