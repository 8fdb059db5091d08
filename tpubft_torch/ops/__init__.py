"""Port of the tpubft.ops package (see the modules for what is ported)."""
