"""wrapper.pack_upload_ms: host ms per scan in the wrapper's pack and
upload (FusedDmsaSlam's Metrics stages pack_fill + upload) over the
window's scans.  Host wrapper layer (pipeline/fused.py FusedDmsaSlam)."""


def read(run):
    st = run["stages"]
    if "pack_fill" not in st or not st["pack_fill"]["calls"]:
        return None
    total = st["pack_fill"]["total_s"] + st.get("upload", {}).get("total_s", 0.0)
    return 1e3 * total / st["pack_fill"]["calls"]
