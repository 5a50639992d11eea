"""Model-parameters loader: reference-compatible inputs, case fan-out.

Reads the reference's Model_Parameters CSV/JSON format (reference:
dervet/DERVETParams.py:56-130 + the storagevet Params surface described in
SURVEY.md §2.8), validates tags/keys against the compact schema, expands the
sensitivity-analysis case matrix (independent cross-product + coupled
columns), and loads referenced datasets (time series, monthly, yearly,
tariff, cycle-life CSVs).

Output is one :class:`CaseParams` per sensitivity case — a plain typed
container the scenario runtime consumes.  No CVXPY, no class-level mutable
registries: initialization is a pure function of the input file.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path, PureWindowsPath
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from .allowed import check_allowed
from .schema import DER_TAGS, SCHEMA, SINGLE_INSTANCE_TAGS
from ..utils.errors import ModelParameterError, TellUser


# ---------------------------------------------------------------------------
# typed value conversion
# ---------------------------------------------------------------------------

_TRUE = {"1", "1.0", "yes", "y", "true"}
_FALSE = {"0", "0.0", "no", "n", "false", "nan", "."}


def parse_list_str(s: Any) -> List[str]:
    """Split a bracketed/comma-separated cell into stripped items (the one
    list syntax shared by CSV, JSON, and XML inputs)."""
    return [p.strip() for p in
            str(s).replace("[", "").replace("]", "").split(",")]


def convert_value(raw: Any, declared: str, key: str = "") -> Any:
    """Convert a raw cell (string) according to the schema's declared type."""
    s = str(raw).strip()
    if declared == "float":
        return float(s)
    if declared == "int":
        return int(float(s))
    if declared == "bool":
        low = s.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ModelParameterError(f"cannot parse bool {raw!r} for {key}")
    if declared == "Period":
        try:
            return int(float(s))
        except ValueError:
            # some reference inputs use date strings, e.g. '1/1/2017'
            return int(pd.to_datetime(s).year)
    if declared == "list/int":
        # reference inputs separate list items with commas OR whitespace
        parts = s.replace("[", "").replace("]", "").replace(",", " ").split()
        return [int(float(p)) for p in parts]
    if declared == "string/int":
        try:
            return int(float(s))
        except ValueError:
            return s
    if declared == "string/float":
        try:
            return float(s)
        except ValueError:
            return s
    # string (includes filenames)
    return s


def _find_case_insensitive(root: Path, rel: Path) -> Optional[Path]:
    """Resolve ``root/rel`` tolerating per-component case mismatches.

    Reference inputs were authored on Windows (case-insensitive FS): e.g. the
    canonical template references ``monthly_Data.csv`` while the file on disk
    is ``monthly_data.csv``."""
    cur = root
    for part in rel.parts:
        nxt = cur / part
        if not nxt.exists():
            if not cur.is_dir():
                return None
            match = next((child for child in cur.iterdir()
                          if child.name.lower() == part.lower()), None)
            if match is None:
                return None
            nxt = match
        cur = nxt
    return cur


def normalize_path(raw: str, base_path: Path) -> Path:
    """Resolve a (possibly Windows-style, possibly relative) file reference."""
    s = str(raw).strip()
    direct = Path(s)
    if direct.is_absolute():
        if direct.exists():
            return direct
        found = _find_case_insensitive(Path(direct.anchor), direct.relative_to(direct.anchor))
        if found is not None:
            return found
    # windows-style normalization for strings like '.\\data\\x.csv'
    p = PureWindowsPath(s)
    parts = [x for x in p.parts if x not in (".", "\\", "/")]
    candidate = Path(*parts) if parts else Path(s)
    for root in (base_path, Path.cwd()):
        full = root / candidate
        if full.exists():
            return full
        found = _find_case_insensitive(root, candidate)
        if found is not None:
            return found
    # last resort: inputs that reference data under the (absent) storagevet
    # submodule, e.g. '.\\dervet\\storagevet\\Data\\x.csv'; the same files
    # ship at '<root>/data/x.csv' in the snapshot.  Restricted to paths that
    # actually point into storagevet so a typo elsewhere still raises.
    if "storagevet" in s.lower():
        for root in (base_path, Path.cwd()):
            found = _find_case_insensitive(root, Path("data") / candidate.name)
            if found is not None:
                return found
    raise ModelParameterError(f"referenced file not found: {raw!r} "
                              f"(searched under {base_path} and cwd)")


# ---------------------------------------------------------------------------
# normalized input rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InputRow:
    tag: str
    id: str
    key: str
    value: Any          # raw string
    type: str
    sensitivity: Optional[List[Any]] = None   # parsed list of raw strings
    coupled: Optional[str] = None             # coupling group label
    # CBA re-pricing ("Evaluation" columns, reference DERVETParams.py:157-467)
    eval_value: Any = None                    # raw string (scalar or list)
    eval_active: bool = False


def _read_csv_rows(path: Path) -> List[InputRow]:
    df = pd.read_csv(path, dtype=str)
    value_col = "Optimization Value" if "Optimization Value" in df.columns else "Value"
    has_id = "ID" in df.columns
    rows = []
    active_pairs = set()
    for _, r in df.iterrows():
        tag = str(r.get("Tag", "")).strip()
        key = r.get("Key")
        if not tag or tag == "Tag" or pd.isna(key):
            continue
        rid = str(r["ID"]).strip() if has_id and not pd.isna(r.get("ID")) else ""
        if rid == ".":
            rid = ""
        active = str(r.get("Active", "")).strip().lower()
        if active in ("yes", "y", "1"):
            active_pairs.add((tag, rid))
        sens_active = str(r.get("Sensitivity Analysis", "")).strip().lower() == "yes"
        sens = None
        if sens_active and not pd.isna(r.get("Sensitivity Parameters")):
            sens = parse_list_str(r["Sensitivity Parameters"])
        coupled = r.get("Coupled")
        coupled = None if (coupled is None or pd.isna(coupled)
                           or str(coupled).strip() in ("None", "")) else str(coupled).strip()
        eval_active = str(r.get("Evaluation Active", "")).strip().lower() \
            in ("yes", "y", "1")
        eval_value = r.get("Evaluation Value")
        if eval_value is not None and pd.isna(eval_value):
            eval_value = None
        rows.append(InputRow(tag=tag, id=rid, key=str(key).strip(),
                             value=r[value_col], type=str(r.get("Type", "string")).strip(),
                             sensitivity=sens, coupled=coupled,
                             eval_value=eval_value, eval_active=eval_active))
    return [r for r in rows if (r.tag, r.id) in active_pairs]


def _read_xml_rows(path: Path) -> List[InputRow]:
    """Read the reference's XML model-parameters format (reference:
    storagevet Params xmlTree surface, exercised at DERVETParams.py:200-260:
    tag elements carry active/id attributes; each key child holds Value/
    Optimization_Value, Type, an `analysis` attribute for sensitivity,
    Sensitivity_Parameters, Coupled, and an optional Evaluation child)."""
    import xml.etree.ElementTree as ET
    tree = ET.parse(path)
    rows: List[InputRow] = []
    for tag in tree.getroot():
        active = (tag.get("active") or "no")[0].lower()
        if active not in ("y", "1"):
            continue
        rid = tag.get("id") or ""
        rid = "" if rid in (".", "None") else rid
        for key in tag:
            val_el = key.find("Optimization_Value")
            if val_el is None:
                val_el = key.find("Value")
            type_el = key.find("Type")
            sens = None
            coupled = None
            analysis = (key.get("analysis") or "no")[0].lower()
            if analysis in ("y", "1"):
                sp = key.find("Sensitivity_Parameters")
                if sp is not None and sp.text:
                    sens = parse_list_str(sp.text)
                cp = key.find("Coupled")
                coupled = cp.text.strip() if cp is not None and cp.text and \
                    cp.text.strip() not in ("None", "") else None
            ev = key.find("Evaluation")
            eval_active = ev is not None and \
                (ev.get("active") or "no")[0].lower() in ("y", "1")
            rows.append(InputRow(
                tag=tag.tag, id=rid, key=key.tag,
                value=val_el.text if val_el is not None else None,
                type=(type_el.text if type_el is not None and type_el.text
                      else SCHEMA.get(tag.tag, {}).get(key.tag, "string")),
                sensitivity=sens, coupled=coupled,
                eval_value=ev.text if eval_active else None,
                eval_active=eval_active))
    return rows


def _read_json_rows(path: Path) -> List[InputRow]:
    tree = json.loads(path.read_text())
    tags = tree.get("tags", tree)
    rows: List[InputRow] = []
    for tag, instances in tags.items():
        for rid, inst in instances.items():
            active = str(inst.get("active", "no")).strip().lower()
            if active not in ("yes", "y", "1"):
                continue
            rid = "" if rid in (".", "None") else str(rid)
            for key, attrs in inst.get("keys", {}).items():
                sens = attrs.get("sensitivity", {})
                sens_list = None
                coupled = None
                if isinstance(sens, dict) and str(sens.get("active", "no")).lower() == "yes":
                    sens_list = parse_list_str(sens.get("value", ""))
                    coupled = sens.get("coupled")
                    coupled = None if coupled in (None, "None", "") else str(coupled)
                ev = attrs.get("evaluation", {})
                eval_active = isinstance(ev, dict) and \
                    str(ev.get("active", "no")).strip().lower() in ("yes", "y", "1")
                rows.append(InputRow(tag=tag, id=rid, key=key,
                                     value=attrs.get("opt_value", attrs.get("value")),
                                     type=str(attrs.get("type", SCHEMA.get(tag, {}).get(key, "string"))),
                                     sensitivity=sens_list, coupled=coupled,
                                     eval_value=(ev.get("value")
                                                 if isinstance(ev, dict) else None),
                                     eval_active=eval_active))
    return rows


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Datasets:
    """Referenced CSV data, normalized to hour-beginning indices."""
    time_series: Optional[pd.DataFrame] = None
    monthly: Optional[pd.DataFrame] = None
    yearly: Optional[pd.DataFrame] = None
    tariff: Optional[pd.DataFrame] = None
    cycle_life: Optional[pd.DataFrame] = None
    load_shed: Optional[pd.DataFrame] = None    # Reliability load-shed curve


def load_time_series(path: Path, dt_hours: float) -> pd.DataFrame:
    df = pd.read_csv(path)
    dt_col = df.columns[0]
    import warnings
    try:
        # vectorized single-format parse (pandas infers from row 0) —
        # format="mixed" falls back to per-element dateutil parsing,
        # ~1.9 s for a year of hourly stamps (profiled r5).  The
        # could-not-infer warning is silenced: falling back IS the plan.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            idx = pd.to_datetime(df[dt_col], dayfirst=False)
    except (ValueError, TypeError):
        idx = pd.to_datetime(df[dt_col], format="mixed", dayfirst=False)
    # the reference's time series are hour-ENDING; convert to hour-beginning
    df = df.drop(columns=[dt_col])
    df.index = idx - pd.Timedelta(hours=dt_hours)
    df.index.name = "Start Datetime (hb)"
    return df


def load_monthly(path: Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    df = df.set_index(["Year", "Month"])
    return df


def load_yearly(path: Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    return df.set_index("Year")


def load_tariff(path: Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    return df.set_index("Billing Period")


# ---------------------------------------------------------------------------
# per-case container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CaseParams:
    case_id: int
    scenario: Dict[str, Any]
    finance: Dict[str, Any]
    results: Dict[str, Any]
    ders: List[Tuple[str, str, Dict[str, Any]]]       # (tag, id, keys)
    streams: Dict[str, Dict[str, Any]]                # tag -> keys
    datasets: Datasets
    overrides: Dict[Tuple[str, str, str], Any] = dataclasses.field(default_factory=dict)
    sensitivity_df: pd.DataFrame = dataclasses.field(default_factory=pd.DataFrame)
    # CBA "Evaluation" re-pricing values keyed like overrides (tag, id, key)
    cba_overrides: Dict[Tuple[str, str, str], Any] = dataclasses.field(default_factory=dict)
    # root for resolving referenced-data paths (evaluation reloads need it)
    base_path: Optional[Path] = None


class Params:
    """Reference-compatible initializer: one CaseParams per sensitivity case.

    Mirrors the surface of ``storagevet.Params.initialize`` +
    ``ParamsDER.initialize`` (SURVEY.md §2.2/§3.5) without class-level state.
    """

    @classmethod
    def initialize(cls, filename, base_path=None, verbose: bool = False
                   ) -> Dict[int, CaseParams]:
        path = Path(filename)
        if not path.exists():
            raise ModelParameterError(f"model parameters file not found: {filename}")
        base = Path(base_path) if base_path else path.parent
        if path.suffix.lower() == ".json":
            rows = _read_json_rows(path)
        elif path.suffix.lower() == ".xml":
            rows = _read_xml_rows(path)
        else:
            rows = _read_csv_rows(path)
        if not rows:
            raise ModelParameterError(f"no active tags found in {filename}")
        cls._validate(rows)
        case_defs, sens_df = cls._case_definitions(rows)
        instances: Dict[int, CaseParams] = {}
        # referenced-data memo for THIS initialize call: a sensitivity
        # sweep re-reads the same timeseries/monthly/tariff files for
        # every case otherwise (measured 47 s of a 128-case sweep's wall
        # clock, r4).  Each case still gets its own shallow copy so
        # per-case mutation cannot leak across the sweep.
        ds_cache: Dict[tuple, Any] = {}
        for case_id, overrides in enumerate(case_defs):
            instances[case_id] = cls._build_case(case_id, rows, overrides,
                                                 base, verbose, ds_cache)
        # attach the sensitivity summary frame to every instance set
        for inst in instances.values():
            inst.sensitivity_df = sens_df
        return instances

    # ------------------------------------------------------------------
    @staticmethod
    def _validate(rows: List[InputRow]) -> None:
        for r in rows:
            if r.tag not in SCHEMA:
                raise ModelParameterError(f"unknown tag {r.tag!r}")
            if r.key not in SCHEMA[r.tag]:
                TellUser.warning(f"unknown key {r.tag}.{r.key} — ignoring schema type")
        seen_single = {}
        for r in rows:
            if r.tag in SINGLE_INSTANCE_TAGS:
                seen_single.setdefault(r.tag, set()).add(r.id)
        for tag, ids in seen_single.items():
            if len(ids) > 1:
                raise ModelParameterError(f"tag {tag} allows only one instance, got ids {ids}")

    # ------------------------------------------------------------------
    @staticmethod
    def _case_definitions(rows: List[InputRow]):
        """Cross-product of independent sensitivity lists; coupled groups
        vary in lockstep (reference: test_1params.py:51-62 semantics)."""
        sens_rows = [r for r in rows if r.sensitivity]
        if not sens_rows:
            return [dict()], pd.DataFrame()
        groups: Dict[str, List[InputRow]] = {}
        for i, r in enumerate(sens_rows):
            label = r.coupled if r.coupled else f"__solo_{i}"
            groups.setdefault(label, []).append(r)
        axes = []
        for label, grp in groups.items():
            n_vals = {len(r.sensitivity) for r in grp}
            if len(n_vals) > 1:
                raise ModelParameterError(
                    f"coupled sensitivity lists must have equal length, group {label}: "
                    f"{[(r.tag, r.key, len(r.sensitivity)) for r in grp]}")
            n = n_vals.pop()
            axes.append([(grp, j) for j in range(n)])
        import itertools
        case_defs = []
        records = []
        for combo in itertools.product(*axes):
            overrides = {}
            rec = {}
            idx_map = {}
            for grp, j in combo:
                for r in grp:
                    overrides[(r.tag, r.id, r.key)] = r.sensitivity[j]
                    idx_map[(r.tag, r.id, r.key)] = j
                    rec[f"{r.tag}/{r.key}"] = r.sensitivity[j]
            overrides["__sens_idx__"] = idx_map
            case_defs.append(overrides)
            records.append(rec)
        return case_defs, pd.DataFrame(records)

    # ------------------------------------------------------------------
    @staticmethod
    def bad_active_combo(ders, streams) -> None:
        """Params-time prediction that a combination of active tags cannot
        produce a solvable run — erroring HERE, before any optimization
        window is assembled, instead of surfacing later as an opaque
        solver/assembly failure (reference: ParamsDER.bad_active_combo,
        dervet/DERVETParams.py:143-155, delegating to the storagevet
        parent with ``dervet=True, other_ders=...``)."""
        der_tags = {t for t, _, _ in ders}
        active_streams = set(streams)
        if not der_tags:
            raise ModelParameterError(
                "no DER technology is active — activate at least one "
                "technology tag (Battery, PV, ICE, …) or there is nothing "
                "to dispatch")
        if not active_streams:
            raise ModelParameterError(
                "no value stream is active — activate at least one service "
                "tag (DA, retailTimeShift, Reliability, …) or there is "
                "nothing to optimize for")
        if {"RA", "DR"} <= active_streams:
            raise ModelParameterError(
                "Resource Adequacy and Demand Response cannot both be "
                "active: their dispatch-constraint days conflict")
        markets = active_streams & {"FR", "SR", "NSR", "LF"}
        dispatchable = der_tags & {"Battery", "CAES", "ICE", "DieselGenset",
                                   "CT", "CHP"}
        if markets and not dispatchable:
            raise ModelParameterError(
                f"market service(s) {sorted(markets)} require a "
                "dispatchable technology (storage or generator); active "
                f"technologies {sorted(der_tags)} cannot hold reserve "
                "capacity")

    # ------------------------------------------------------------------
    @staticmethod
    def _load_cached(ds_cache, key, loader):
        if ds_cache is None:
            return loader()
        if key not in ds_cache:
            ds_cache[key] = loader()
        return ds_cache[key].copy()

    # ------------------------------------------------------------------
    @classmethod
    def _build_case(cls, case_id, rows, overrides, base, verbose,
                    ds_cache=None) -> CaseParams:
        overrides = dict(overrides)
        sens_idx = overrides.pop("__sens_idx__", {})
        tag_maps: Dict[Tuple[str, str], Dict[str, Any]] = {}
        cba_overrides: Dict[Tuple[str, str, str], Any] = {}
        for r in rows:
            if r.eval_active and r.eval_value is not None:
                declared = SCHEMA.get(r.tag, {}).get(r.key, r.type or "string")
                raw_ev = str(r.eval_value)
                if r.sensitivity:
                    # evaluation values coupled to a sensitivity sweep must
                    # supply one value per sensitivity entry (reference:
                    # test_cba.py test_catch_wrong_length)
                    parts = parse_list_str(raw_ev)
                    if len(parts) != len(r.sensitivity):
                        raise ModelParameterError(
                            f"Evaluation list for {r.tag}.{r.key} has "
                            f"{len(parts)} values but the sensitivity sweep "
                            f"has {len(r.sensitivity)}")
                    j = sens_idx.get((r.tag, r.id, r.key), 0)
                    raw_ev = parts[j]
                try:
                    ev = convert_value(raw_ev, declared,
                                       key=f"{r.tag}.{r.key}")
                    err = check_allowed(r.tag, r.key, ev)
                    if err:
                        raise ModelParameterError(f"Evaluation value: {err}")
                    cba_overrides[(r.tag, r.id, r.key)] = ev
                except (ValueError, TypeError) as e:
                    raise ModelParameterError(
                        f"bad Evaluation value {raw_ev!r} for "
                        f"{r.tag}.{r.key}: {e}")
        for r in rows:
            raw = overrides.get((r.tag, r.id, r.key), r.value)
            declared = SCHEMA.get(r.tag, {}).get(r.key, r.type or "string")
            try:
                val = convert_value(raw, declared, key=f"{r.tag}.{r.key}")
            except (ValueError, TypeError) as e:
                raise ModelParameterError(
                    f"bad value {raw!r} for {r.tag}.{r.key} (type {declared}): {e}")
            err = check_allowed(r.tag, r.key, val)
            if err:
                raise ModelParameterError(err)
            tag_maps.setdefault((r.tag, r.id), {})[r.key] = val

        scenario = next((v for (t, _), v in tag_maps.items() if t == "Scenario"), {})
        finance = next((v for (t, _), v in tag_maps.items() if t == "Finance"), {})
        results = next((v for (t, _), v in tag_maps.items() if t == "Results"), {})
        if not scenario:
            raise ModelParameterError("Scenario tag is required")
        if not finance:
            raise ModelParameterError("Finance tag is required")
        ders = [(t, i, v) for (t, i), v in tag_maps.items() if t in DER_TAGS]
        streams = {t: v for (t, _), v in tag_maps.items()
                   if t in SINGLE_INSTANCE_TAGS and t not in ("Scenario", "Finance", "Results")}

        datasets = Datasets()
        dt = float(scenario.get("dt", 1))
        if scenario.get("time_series_filename"):
            p = normalize_path(scenario["time_series_filename"], base)
            datasets.time_series = cls._load_cached(
                ds_cache, ("ts", str(p), dt),
                lambda: load_time_series(p, dt))
        if scenario.get("monthly_data_filename"):
            p = normalize_path(scenario["monthly_data_filename"], base)
            datasets.monthly = cls._load_cached(
                ds_cache, ("monthly", str(p)), lambda: load_monthly(p))
        if finance.get("yearly_data_filename"):
            p = normalize_path(finance["yearly_data_filename"], base)
            datasets.yearly = cls._load_cached(
                ds_cache, ("yearly", str(p)), lambda: load_yearly(p))
        if finance.get("customer_tariff_filename"):
            p = normalize_path(finance["customer_tariff_filename"], base)
            datasets.tariff = cls._load_cached(
                ds_cache, ("tariff", str(p)), lambda: load_tariff(p))
        for tag, _, keys in ders:
            if tag == "Battery" and keys.get("incl_cycle_degrade") and \
                    keys.get("cycle_life_filename"):
                p = normalize_path(keys["cycle_life_filename"], base)
                datasets.cycle_life = cls._load_cached(
                    ds_cache, ("cycle", str(p)), lambda: pd.read_csv(p))
        rel = streams.get("Reliability", {})
        if rel.get("load_shed_percentage") and rel.get("load_shed_perc_filename"):
            p = normalize_path(rel["load_shed_perc_filename"], base)
            datasets.load_shed = cls._load_cached(
                ds_cache, ("shed", str(p)), lambda: pd.read_csv(p))
        cls.bad_active_combo(ders, streams)
        return CaseParams(case_id=case_id, scenario=scenario, finance=finance,
                          results=results, ders=ders, streams=streams,
                          datasets=datasets, overrides=dict(overrides),
                          cba_overrides=cba_overrides, base_path=base)
