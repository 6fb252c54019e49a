"""EIP-4844 blob KZG on the card — the port of grandine_tpu/kzg/: the six
public calls (eip4844.py), the trusted setup (setup.py, with the port's own
copy of the ceremony file under data/) and the Fr helpers (fr.py). The two
device programs, the setup MSM and the batch blob-proof verdict, run on
gpu/kzg.py."""
