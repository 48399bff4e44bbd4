"""Device resolution and precision pinning shared by the port."""
