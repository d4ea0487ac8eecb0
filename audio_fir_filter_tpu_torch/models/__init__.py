from .fir import (
    FILTER_TYPES,
    BandPass,
    BandReject,
    FIRFilter,
    HighPass,
    LowCut,
    LowPass,
    make_model,
)

__all__ = ["FIRFilter", "LowCut", "HighPass", "LowPass", "BandPass",
           "BandReject", "FILTER_TYPES", "make_model"]
