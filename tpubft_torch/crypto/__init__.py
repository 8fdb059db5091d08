"""Port of the tpubft.crypto package (see the modules for what is ported)."""
