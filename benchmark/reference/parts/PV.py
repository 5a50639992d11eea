"""PV (DER-VET's PV tag): output up to the rated capacity times the
per-rated-kW profile where it may be curtailed, exactly that otherwise."""
KEYS = {"name", "rated_capacity", "curtail", "ccost_kW"}
COL = "PV Gen (kW/rated kW)"
RESULTS = {"gen": "Electric Generation (kW)"}


def build(lp, label: str, keys: dict, ts) -> None:
    extra = {k for k, v in keys.items() if k not in KEYS and v}
    if extra:
        raise ValueError(f"{label}: keys {sorted(extra)} are not in the "
                         "reference")
    top = ts[COL].to_numpy() * float(keys["rated_capacity"])
    gen = lp.var(f"{label}/gen", lp.T, 0.0 if keys.get("curtail") else top,
                 top)
    lp.power[gen] = 1.0


def mix(keys: dict, ts):
    """This PV's most output over the whole horizon, for an outage walk."""
    return ts[COL].to_numpy() * float(keys["rated_capacity"])
