"""The fault-tolerant training runtime: heartbeat, straggler monitor,
bounded-restart supervision (`fault`)."""
