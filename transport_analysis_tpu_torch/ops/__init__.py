from .acf import acf_fft, acf_fft_from_f32, acf_windowed
from .cuda_lag import windowed_lag
from .einstein import (
    einstein_difference_fft,
    einstein_difference_fft_from_f32,
    einstein_difference_windowed,
    msd_fft,
)
from .integrate import (
    trapezoid,
    simpson,
    cumulative_trapezoid,
    polyfit_linear,
)

__all__ = [
    "acf_fft",
    "acf_fft_from_f32",
    "acf_windowed",
    "einstein_difference_fft",
    "einstein_difference_fft_from_f32",
    "einstein_difference_windowed",
    "msd_fft",
    "windowed_lag",
    "trapezoid",
    "simpson",
    "cumulative_trapezoid",
    "polyfit_linear",
]
