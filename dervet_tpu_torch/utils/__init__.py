from .errors import (ModelParameterError, ParameterError, SolverError,
                     TellUser, TimeseriesDataError)

__all__ = ["ModelParameterError", "ParameterError", "SolverError",
           "TellUser", "TimeseriesDataError"]
