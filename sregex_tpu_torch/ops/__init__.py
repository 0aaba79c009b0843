"""Device tiers of the port: layout, prep, the scan kernel's wrapper
and plain version, pair tables, and the kernel build."""
