"""The benchmark's harness: the one generator of traffic, the server it
drives, the client process, the device trace and the check."""
