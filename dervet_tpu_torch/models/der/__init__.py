"""DER technology components."""
from .base import DER
from .ess import Battery, EnergyStorage
