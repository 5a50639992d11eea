"""Growth fill / drop of referenced time-series data.

Re-implements the behavior of the storagevet ``Library.fill_extra_data`` /
``drop_extra_data`` helpers (SURVEY.md §2.8; used via per-component
``grow_drop_data`` during ``fill_and_drop_extra_data``,
reference DERVET.py:79 + e.g. CombustionTurbine.py:64-77): optimization
years with no time-series data are synthesized from the nearest available
year, scaled by the owning component's yearly growth rate — load columns
grow at the Scenario ``def_growth`` rate, each value stream's price columns
at that stream's ``growth`` key, physical profiles (PV per-kW output,
normalized signals) copy unscaled.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd

from ..utils.errors import TellUser

# column-stem -> stream tag whose 'growth' key applies (reference: each
# stream grows its own price data in grow_drop_data)
PRICE_COLUMN_STREAMS = {
    "DA Price ($/kWh)": "DA",
    "FR Price ($/kW)": "FR",
    "Reg Up Price ($/kW)": "FR",
    "Reg Down Price ($/kW)": "FR",
    "SR Price ($/kW)": "SR",
    "NSR Price ($/kW)": "NSR",
    "LF Up Price ($/kW)": "LF",
    "LF Down Price ($/kW)": "LF",
    # the deferral load grows at the Deferral stream's own rate, not the
    # scenario default (reference: per-component grow_drop_data)
    "Deferral Load (kW)": "Deferral",
}

LOAD_STEMS = ("Load (kW)",)


def column_growth_rates(scenario: Dict, streams: Dict[str, Dict],
                        columns) -> Dict[str, float]:
    """Per-column yearly growth fraction."""
    import re
    def_growth = float(scenario.get("def_growth", 0) or 0) / 100.0
    rates: Dict[str, float] = {}
    for col in columns:
        # strip only a trailing per-instance id suffix ('.../1'), not the
        # '/' inside units like ($/kWh)
        stem = re.sub(r"/\w+$", "",
                      str(col).strip()) if re.search(r"/\w+$", str(col)) and \
            not str(col).rstrip().endswith(")") else str(col).strip()
        if stem in PRICE_COLUMN_STREAMS:
            tag = PRICE_COLUMN_STREAMS[stem]
            rates[col] = float(streams.get(tag, {}).get("growth", 0) or 0) / 100.0
        elif any(stem.endswith(s) for s in LOAD_STEMS):
            rates[col] = def_growth
        else:
            rates[col] = 0.0
    return rates


def fill_extra_data(ts: pd.DataFrame, opt_years: List[int],
                    rates: Dict[str, float]) -> pd.DataFrame:
    """Synthesize missing optimization years from the nearest data year."""
    have = sorted(set(ts.index.year))
    missing = [y for y in opt_years if y not in have]
    if not missing:
        return ts
    frames = [ts]
    for yr in missing:
        src = min(have, key=lambda h: abs(h - yr))
        src_block = ts[ts.index.year == src]
        # re-stamp the source year's timestamps into the target year,
        # dropping a source leap day the target lacks
        new_index = pd.DatetimeIndex([
            t.replace(year=yr) for t in src_block.index
            if not (t.month == 2 and t.day == 29)])
        src_vals = src_block[~((src_block.index.month == 2)
                               & (src_block.index.day == 29))]
        block = pd.DataFrame(src_vals.to_numpy(), index=new_index,
                             columns=ts.columns)
        # leap target from non-leap source: repeat Feb 28 as Feb 29
        if pd.Timestamp(year=yr, month=1, day=1).is_leap_year and \
                not ((block.index.month == 2) & (block.index.day == 29)).any():
            feb28 = block[(block.index.month == 2) & (block.index.day == 28)]
            feb29 = feb28.copy()
            feb29.index = feb29.index + pd.Timedelta(days=1)
            block = pd.concat([block, feb29]).sort_index()
        dy = yr - src
        for col in ts.columns:
            rate = rates.get(col, 0.0)
            if rate:
                block[col] = block[col] * (1.0 + rate) ** dy
        TellUser.info(f"time series for {yr} synthesized from {src} "
                      f"(growth-filled)")
        frames.append(block)
    out = pd.concat(frames).sort_index()
    return out[~out.index.duplicated(keep="first")]


def fill_extra_monthly(monthly: pd.DataFrame, opt_years: List[int]
                       ) -> pd.DataFrame:
    """Copy the nearest year's monthly rows for missing years (reference:
    test 039-mutli_opt_years_not_in_monthly_data)."""
    if monthly is None:
        return monthly
    have = sorted({y for y, _ in monthly.index})
    missing = [y for y in opt_years if y not in have]
    if not missing:
        return monthly
    frames = [monthly]
    for yr in missing:
        src = min(have, key=lambda h: abs(h - yr))
        block = monthly.loc[[i for i in monthly.index if i[0] == src]].copy()
        block.index = pd.MultiIndex.from_tuples(
            [(yr, m) for _, m in block.index], names=monthly.index.names)
        frames.append(block)
    out = pd.concat(frames).sort_index()
    return out[~out.index.duplicated(keep="first")]
