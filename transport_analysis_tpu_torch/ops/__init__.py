from .acf import acf_fft, acf_fft_from_f32, acf_windowed
from .einstein import einstein_difference_fft, einstein_difference_windowed
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
    "einstein_difference_windowed",
    "trapezoid",
    "simpson",
    "cumulative_trapezoid",
    "polyfit_linear",
]
