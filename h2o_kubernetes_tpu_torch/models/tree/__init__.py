"""Tree-ensemble serving: flattened scoring and TreeSHAP."""
