"""CSPDarknet, YOLOPAFPN, the YOLOX head and the YOLOX model."""
