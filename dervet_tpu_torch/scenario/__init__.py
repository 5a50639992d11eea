"""Scenario runtime: windows, POI, service aggregator, dispatch loop."""
from .scenario import MicrogridScenario
from .poi import POI
from .aggregator import ServiceAggregator
