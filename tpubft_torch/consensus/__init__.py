"""Port of the tpubft.consensus package (see the modules for what is ported)."""
