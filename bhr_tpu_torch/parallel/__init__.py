"""Multi-device frame rendering: frames and row bands over a device grid."""
