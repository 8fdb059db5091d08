"""Port of the tpubft.utils package (see the modules for what is ported)."""
