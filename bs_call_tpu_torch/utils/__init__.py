import os


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env var with conventional falsy spellings. Unset (or
    empty) -> `default`; "0"/"false"/"off"/"no" (any case) -> False;
    anything else -> True. (ADVICE r03: `BS_CALL_EMIT_TIER=off` used to
    ENABLE the tier because only the literal "0" opted out.)"""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "off", "no")
