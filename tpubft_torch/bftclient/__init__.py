"""BFT client stack (reference concord-bft client/bftclient/)."""
from tpubft_torch.bftclient.client import BftClient, ClientConfig, Quorum
from tpubft_torch.bftclient.pool import ClientPool, MuxSession, SessionMux

__all__ = ["BftClient", "ClientConfig", "Quorum", "ClientPool",
           "MuxSession", "SessionMux"]
