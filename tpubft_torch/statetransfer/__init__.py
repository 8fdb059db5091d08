"""State transfer of the port. Only the window-digest step of
tpubft/statetransfer/manager.py is ported (statetransfer/digests.py); the
fetch, validation and adoption planes wait for their slice."""
