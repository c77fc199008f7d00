"""Device milliseconds of host-to-device copies per request, from the
profiled stretch (the copy itself; a pageable staging stall shows as idle
device time, not here)."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["htod_s"]:
        return None
    return 1e3 * trace["htod_s"] / record["items_traced"]
