"""The filter's tables as the engine holds them on the card, in GB: the
part of device_peak_GB that the configuration's filter fixes."""


def read(out):
    tables = out.get("layer", {}).get("tables_bytes")
    return tables / 1e9 if tables else None
